"""Query executor: the dense PQL read path, BSI int fields and the writes.

Trimmed port of pilosa_tpu/executor.py. For a query the executor

  1. walks the bitmap call tree and resolves every Row (and the existence
     row of Not) to a device-resident [S, W] leaf through the
     generation-keyed DeviceResidency (executor.py:640, :1189-1331); a
     Range(v op x) condition becomes a leaf too, the bsi_compare kernel's
     mask over the field's resident plane slab (:1253-1268),
  2. compiles the tree to the nested-tuple program of parallel/mesh.py,
  3. evaluates it on the device: Count of a 1- or 2-leaf program goes
     through the CountBatcher (pair-stream kernel), every other Count
     through DeviceRunner.count_total_leaves (program_count kernel, 3+-way
     AND chains included), Row results through row_leaves_dev,
  4. finishes counts in int64 and Row segments on the host.

Sum/Min/Max over an int field (:1651-1831) take the field's [D, S, W]
plane slab and its not-null row, AND in an optional filter composed on the
device, and run Sum through the PlaneSumBatcher (bsi_sum_counts kernel),
Min/Max through the MinMaxBatcher (:175-184, :1812-1817; the batched
descent of ops/bsi.py, D + 1 bsi_sum_counts launches a batch), or one
query at a time through the greedy descents of ops/bsi.py when batching is
off. Totals finish exactly on the host: value = sum of 2^i * count_i +
min * count.

TopN (:1835-2164) picks candidates from the per-shard rank caches (merged
across shards, memoized on the caches' versions) and recounts them
exactly: from container metadata without a Src; with one, over frozen
fragments in host array math linear in the candidates' stored bits
(_topn_src_sparse, :2066-2112), else through the topn_counts_packed
kernel (the threshold-pruned walk over 256-row blocks, the Tanimoto band,
the ids= recount). Rows (:2168-2215)
reads row ids from the fragments. GroupBy (:2217-2423) stacks each Rows
axis into one resident [R, S, W] slab and counts every level past the
first with the cross_count_matrix kernel, pruned on the device, one host
fetch per level.

Not(x) is existence &~ x (executor.py:1317-1322). A time Range(f=row,
start, end) is a leaf too: the OR of the row over the views that cover
[start, end) (models/timequantum.py), built on the host and resident
under every covered view's generations (:1236-1252, :1622-1640).

Rows are read the same way from set, mutex, bool and time fields (the
standard view holds every bit of a time field); a bool row may be given
as true or false.

Row and existence leaves take the form the HybridManager picks per row
(planner.choose_representation; executor.py:1209-1292): a sparse index
array, run intervals or a dense plane. A program with a sparse or run leaf
evaluates through ops/hybrid.py eval_hybrid, every sparse∩dense node on
the sparse_intersect_dense kernel; its Count finishes through
hybrid_count before the CountBatcher, whose kernels read only planes
(:1537-1557). A dense consumer of a row (a TopN recount, a Sum filter)
gets the plane from a resident sparse or run twin on the device rather
than from the host (:665-696).

Writes (:500-540, :3169-3760): a query of Set/Clear calls only goes
through the IngestBatcher (parallel/ingest.py) while
PILOSA_TPU_TORCH_INGEST is not 0. Each batch is applied once per fragment
(Fragment.apply_batch: one WAL group commit, one generation bump), the
rank caches and the hybrid hysteresis are updated once per changed row,
existence is marked through the same batch apply, and the resident dense
and sparse leaves of the changed rows are patched in place on the device
(DeviceResidency.patch_entries; run leaves are dropped), so a read after
a write uploads nothing. What the batch cannot take as the per-bit path
would (int fields, mutex, bool and time fields, timestamps, missing
fields) takes the per-bit path; string keys are translated first. ClearRow, Store and Options
(:2535-2577, :3824-3836) run per call; the port logs ClearRow's and
Store's bits to the WAL, so they survive a reopen (the JAX package's do
not: ROADMAP Queue C 5). Reads of an index wait while a batch is
applied to it and its leaves patched (ApplyFence, the port's own), so no
read builds a key whose generations are half before and half after a
batch.

Observability (executor.py:118, :151-169, :546-560): the executor owns a
stats client, a tracer and the fragment heat map. Each call counts
`query/<name>`, runs under an `executor.<name>` span and records its time
on the query's profile. Every row leaf read charges the heat map once
over its shard set (:656-663, :755, :797), a write charges its fragments
(the batched apply once per (field, view), :3528-3540; the per-bit path
as :2495-2532), and hbm_snapshot (:877) joins the resident bytes with the
CUDA allocator's. The sparse and run steps, the BSI descents, the TopN
recounts and the write path's patches are timed as kernel families
(utils/telemetry.py).

Planning (executor.py:243-259, :573-594, :1333-1521): every Count, TopN,
Sum/Min/Max, GroupBy and bitmap call first passes the QueryPlanner
(planner.py), which reorders commutative operands into one canonical
order, rewrites provably empty branches to Union() and marks pushdowns;
its plan node rides the query's profile. Evaluated bitmap subtrees (a Row
result, a TopN Src, a Sum or GroupBy filter) and Count scalars are kept
in the PlanCache (parallel/residency.py) under the planner's generation
keys: a hit reads no leaf and launches nothing, a write changes the key.
A Count or Row of Union() answers with no leaf and no launch.
explain_call (:958-1186) gives the planned tree with each leaf's form,
residency and estimated upload bytes without launching anything.
PILOSA_TPU_TORCH_PLANNER=0 and PILOSA_TPU_TORCH_PLAN_CACHE=0 switch them
off when the executor is built; `plan_cache.enabled` switches the cache at
run time.

String keys (executor.py:2427-2590): with a translator (the server's
utils/translate.py store), a string row or column argument is a key.
Writes mint keys (Set, Store, SetRowAttrs, SetColumnAttrs); every read
translates with create=False, so an unknown key is an empty row and mints
nothing (a Clear or ClearRow of one changes nothing). Results name their
rows by key on keyed fields (_translate_result): TopN pairs, Rows, GroupBy
groups, Options-wrapped calls too; a Row's column keys are rendered by the
API. Keyed Set/Clear envelopes are translated on the submitting thread and
go through the IngestBatcher like unkeyed ones (executor.py:3171-3260).

Attributes: SetRowAttrs and SetColumnAttrs merge into the field's and the
index's AttrStore; a top-level Row() result carries its row's attributes
(:1476-1480), and TopN's attrName/attrValues keep only the candidates
whose attribute is one of the values (:1860-1892).

The cluster (executor.py:491-560, :2664-3156, :3266-3427, :3751-3822):
with a Cluster and an InternalClient and more than one node, a query that
is not itself a fan-out sub-request (remote=True) is distributed. Options
is unwrapped first; a read is routed (_ici_route: "auto" runs a shard set
this node holds every shard of here as one mesh program where its runner
has a mesh, and crosses nodes on a single-device runner; "on" runs such a
set here on either, a decision memoized per topology whose changes and
flips go to the event journal), grouped by each shard's first live owner,
run on this node inline and on every other node through the fan-out
pool, each node's batch coalesced into /internal/query-batch envelopes by
the NodeCoalescer (net/coalesce.py), optionally hedged onto another replica
after hedge_delay, and re-mapped shard by shard onto the next replica
when a node fails. The partials reduce associatively (_reduce); TopN
recounts its winners exactly on every owner (_recount_topn, ids= without
n), and GroupBy's limit applies after the reduce. Writes go to every
replica of the column's shard (Set, Clear, SetColumnAttrs), to every node
(SetRowAttrs) or to every owner of the query's shards (Store, ClearRow),
never coalesced or hedged, the remote replicas before this node; a
replica that cannot be reached fails the write ("replica write failed"),
and a Set that creates a shard announces it to every node before it is
acknowledged. A coalesced Set/Clear batch sends each other replica one
multi-call remote=true envelope, which the replica applies directly
(_execute_ingest_remote), then applies here what no replica refused
(_apply_ingest_distributed). Deadlines (utils/qctx.py) are checked between
calls and node batches. The index's apply fence (ApplyFence) is held only
around this node's own share, never across an RPC, and a batch's only
around its local apply.

Liveness and healing (executor.py:265-282, :384-480, :3034-3166,
:3303-3427): a replica the server's probing marked down (or that
announced a drain) is skipped by every write, which is then acknowledged
by its live replicas with a durable hint appended for the skipped one
(`hints`, a storage/hints.py HintStore, set by the server; None writes no
hint); a replica that answers "draining", or was marked down between
planning and send, is demoted to a hint the same way. With every owner
unavailable the write is refused ("all replicas down for write"); an
owner that is dead but not yet marked down still refuses it ("replica
write failed"). The read fence (read_fence: (index, shard) pairs a
rejoining node may hold stale) re-routes this node's fenced shards onto
the next live replica in the fan-out plan (_fanout_groups), refuses them
to a coordinator's remote=true read with the code `read-fenced`, so its
per-shard failover serves them elsewhere, and serves them stale only when
no replica is live (_check_remote_fence).

QoS and accounting (executor.py:316-332, :1343-1374, :1535-1593,
:3284-3301): the fan-out and inbound envelope pools are PriorityPools
(qos.py) unless PILOSA_TPU_TORCH_QOS=0, so a batch tenant's node batches
and envelope entries queue behind interactive ones; a composed subtree
evaluated on a plan-cache miss and an un-batched Count (program_count,
or the hybrid kernels) charge their wall time to the request's account
as device_ms (a batched Count is charged by the batcher); the ingest
apply runs under the `batch` class.

The mesh (Executor(mesh=), parallel/mesh.py): every leaf is blocked over
the mesh's positions, the kernel wrappers and the shard-local steps run
per block (parallel/blocks.py), counts finish in int64 over the slots,
and a host result reads the first replica row's blocks and keeps the
real shards only (pad shards are empty in every form, and Not() goes
through existence).

Calls and options outside the slice raise NotPortedError (a 400 at the
API).
"""

from __future__ import annotations

import contextlib
import heapq
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from pilosa_tpu_torch import planner, qos
from pilosa_tpu_torch.constants import (
    EXISTENCE_FIELD_NAME,
    SHARD_WIDTH,
    WORDS_PER_SHARD,
)
from pilosa_tpu_torch.models.cache import merge_pair_arrays, merge_pairs
from pilosa_tpu_torch.models import timequantum
from pilosa_tpu_torch.models.field import INT, SET, NotPortedError
from pilosa_tpu_torch.models.index import Index
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.models.view import VIEW_BSI_PREFIX, VIEW_STANDARD
from pilosa_tpu_torch.net.client import ClientError
from pilosa_tpu_torch.net.coalesce import NodeCoalescer
from pilosa_tpu_torch.ops import bsi
from pilosa_tpu_torch.ops import hybrid as hy
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitvector import (
    band,
    columns_from_planes,
    patch_dense_words,
    patch_sparse_rows,
)
from pilosa_tpu_torch.ops.topn import tanimoto_mask
from pilosa_tpu_torch.parallel.batcher import (
    CountBatcher,
    MinMaxBatcher,
    PlaneSumBatcher,
)
from pilosa_tpu_torch.parallel.ingest import (
    ApplyFence,
    IngestBatcher,
    Mutation,
    ingest_env_enabled,
)
from pilosa_tpu_torch.parallel.blocks import is_blocked
from pilosa_tpu_torch.parallel.mesh import (
    DeviceRunner,
    ici_program_cache_stats,
)
from pilosa_tpu_torch.parallel.residency import (
    DeviceResidency,
    HybridManager,
    PlanCache,
)
from pilosa_tpu_torch.pql import Call, Query, parse_string_cached
from pilosa_tpu_torch.pql.parser import parse_mutations_fast
from pilosa_tpu_torch.utils import accounting
from pilosa_tpu_torch.utils import events as _events
from pilosa_tpu_torch.utils import failpoints, threads
from pilosa_tpu_torch.pql.ast import (
    BETWEEN,
    EQ,
    GT,
    GTE,
    LT,
    LTE,
    NEQ,
    WRITE_CALLS,
    Condition,
)
from pilosa_tpu_torch.utils import heat as _heat
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import qctx, telemetry
from pilosa_tpu_torch.utils.stats import NopStatsClient
from pilosa_tpu_torch.utils.tracing import NopTracer

BITMAP_CALLS = planner.BITMAP_CALLS
_BATCHABLE_OPS = ("and", "or", "xor", "andnot")
_BSI_OPS = {LT: bsi.LT, LTE: bsi.LTE, GT: bsi.GT, GTE: bsi.GTE, EQ: bsi.EQ,
            NEQ: bsi.NEQ}
# candidates per step of the TopN walk: the unit of its prune test, as in
# the JAX package, so both stop at the same block
TOPN_BLOCK = 256
# leaves per topn_counts_packed launch: 64 x 128 MiB at 1024 shards
TOPN_LAUNCH_ROWS = 64
# cross-shard TopN candidate merges kept (LRU)
TOPN_MEMO_ENTRIES = 256
# where host work (the sparse Src walk) is timed as a kernel family
_HOST = torch.device("cpu")
# static bound of a GroupBy chunk's pruned transfer; a chunk with more
# live groups refetches its whole count matrix
GROUPBY_LIVE_CAP = 1 << 16


class ExecutionError(ValueError):
    pass


def _minted(id_: Optional[int], key: str, create: bool) -> Optional[int]:
    """A translated key; a write's key left without an id (a cluster's
    translation primary did not answer) fails the write."""
    if id_ is None and create:
        raise ExecutionError(f"translating key {key!r}: no id from the "
                             "translation primary")
    return id_


class ValCount:
    """Sum/Min/Max result (pilosa_tpu/executor.py:85-101)."""

    __slots__ = ("val", "count")

    def __init__(self, val: int = 0, count: int = 0):
        self.val = val
        self.count = count

    def to_json_dict(self) -> dict:
        return {"value": self.val, "count": self.count}

    def __eq__(self, other):
        return (isinstance(other, ValCount)
                and (self.val, self.count) == (other.val, other.count))

    def __repr__(self):
        return f"ValCount(val={self.val}, count={self.count})"


class Pairs(list):
    """TopN result: [(row_id, count)] (pilosa_tpu/executor.py:63-71);
    `row_keys` the rows' keys on a keyed field (not `keys`: dict() would
    take a list with a keys attribute for a mapping)."""

    row_keys: Optional[list] = None


class RowIdentifiers(list):
    """Rows result: ascending row ids (executor.py:73-79); `row_keys` the
    rows' keys on a keyed field."""

    row_keys: Optional[list] = None


class GroupCounts(list):
    """GroupBy result: [{"group": [...], "count": n}] (executor.py:81-82)."""


@contextlib.contextmanager
def _charged():
    """Charge the wall time of the block to the request's usage account
    as device_ms (this query's own launches; no device sync)."""
    acct = accounting.current_account.get()
    if acct is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acct.charge(device_ms=(time.perf_counter() - t0) * 1e3)


class Executor:
    WRITE_CALLS = WRITE_CALLS
    # route labels of distributed reads (the /metrics
    # pilosa_iciServing_total{route=} keys)
    ROUTE_SLICE_LOCAL = "slice_local"
    ROUTE_CROSS_SLICE = "cross_slice"
    ROUTE_FALLBACK = "fallback"

    def __init__(self, holder, device="cuda", translator=None,
                 cluster=None, client=None, mesh=None):
        self.holder = holder
        # utils/translate.py TranslateStore, or a server's
        # ClusterTranslator (None: string keys raise)
        self.translator = translator
        # the cluster (parallel/cluster.py) and the internal client
        # (net/client.py): with both and more than one node, queries fan
        # out (executor.py:111-112, :193-285)
        self.cluster = cluster
        self.client = client
        self.coalescer = None
        if (client is not None and os.environ.get(
                "PILOSA_TPU_TORCH_NET_COALESCE", "1") != "0"):
            self.coalescer = NodeCoalescer(client)
        self.fanout_pool_size = 32
        self.batch_exec_pool_size = 16
        self._fanout_pool = None
        self._batch_exec_pool = None
        self._hedge_pool = None
        self._pool_lock = threading.Lock()
        self.hedge_delay = 0.0  # seconds; 0: reads are never hedged
        self.hedges_fired = 0
        self.hedges_won = 0
        self.hedges_cancelled = 0
        self._hedge_lock = threading.Lock()
        self.ici_mode = "auto"
        self.ici_slice_local = 0
        self.ici_cross_slice = 0
        self.ici_fallback = 0
        self._ici_lock = threading.Lock()
        # the co-residency memo of "on" routing: (index, shards) -> bool
        # under one topology fingerprint, the last topology's memo kept to
        # see a decision flip (:2620-2660); `journal` (the server's
        # EventJournal) records the flips
        self.journal = None
        self._ici_topo_fp = None
        self._ici_route_memo: OrderedDict = OrderedDict()
        self._ici_prev_memo: dict = {}
        # announce_shard_fn(index, field, shard): the server's bounded
        # synchronous create-shard broadcast, run before a Set that
        # created a shard is acknowledged
        self.announce_shard_fn = None
        # the server's HintStore: writes skipped on unavailable replicas
        self.hints = None
        # the rejoin read fence: (index, shard) pairs this node may hold
        # stale until a block-checksum check lifts them
        self.read_fence: set[tuple[str, int]] = set()
        self._fence_lock = threading.Lock()
        self.fence_rerouted = 0  # local fenced shards planned elsewhere
        self.fence_refused = 0  # remote reads refused into failover
        self.fence_served_stale = 0  # no live replica: served from here
        # with a mesh (parallel/mesh.py), every leaf is blocked over its
        # positions and the kernels launch per block
        self.runner = DeviceRunner(device, mesh=mesh)
        # observability: nop until a Server installs its stats client and
        # tracer; the heat map unless PILOSA_TPU_TORCH_HEAT=0
        self.stats = NopStatsClient()
        self.tracer = NopTracer()
        self.heat = _heat.HeatTracker() if _heat.enabled() else None
        self.residency = DeviceResidency(self.runner)
        # a mesh holds a copy of each leaf per replica row: the budget
        # counts one (parallel/residency.py)
        self.residency.budget = int(self.residency.budget
                                    * self.runner.budget_scale)
        self.residency.heat = self.heat
        self.hybrid = HybridManager(heat=self.heat)
        # PILOSA_TPU_TORCH_BATCH=0: one launch per Count and per Sum, no
        # coalescing
        batch = os.environ.get("PILOSA_TPU_TORCH_BATCH", "1") != "0"
        self.batcher = CountBatcher(runner=self.runner) if batch else None
        self.sum_batcher = PlaneSumBatcher() if batch else None
        self.minmax_batcher = MinMaxBatcher() if batch else None
        # the planner and the plan cache, unless PILOSA_TPU_TORCH_PLANNER=0
        # or PILOSA_TPU_TORCH_PLAN_CACHE=0 (Server(plan=, plan_cache_bytes=)
        # can turn them off too)
        self.planner = None
        if os.environ.get("PILOSA_TPU_TORCH_PLANNER", "1") != "0":
            self.planner = planner.QueryPlanner(self)
        self.plan_cache = None
        if os.environ.get("PILOSA_TPU_TORCH_PLAN_CACHE", "1") != "0":
            self.plan_cache = PlanCache()
        # rows recounted by TopN walks, and GroupBy's blocking fetches (at
        # most one per level, plus one per overflowing chunk)
        self.topn_recount_rows = 0
        self.groupby_host_syncs = 0
        self._stats_lock = threading.Lock()  # request threads share them
        self.groupby_live_cap = GROUPBY_LIVE_CAP
        # (index, field, shards) -> (cache versions, merged ids, counts)
        self._topn_merge_memo: OrderedDict = OrderedDict()
        self._topn_memo_lock = threading.Lock()
        # coalesced Set/Clear (parallel/ingest.py); the kill switch is read
        # per query in execute(), so the batcher always exists
        self.ingest = IngestBatcher(self._apply_ingest_batch)
        self._ingest_lock = threading.Lock()
        self._fences: dict = {}  # index name -> ApplyFence
        self.ingest_stats = {
            "appliedBatches": 0,   # per-fragment batch applies
            "walAppends": 0,       # WAL group commits (one fsync at most)
            "walOps": 0,           # net records written
            "errors": 0,           # failed mutations
            "patchedDense": 0,     # resident dense leaves patched
            "patchedSparse": 0,    # resident sparse leaves patched
            "patchDropped": 0,     # resident leaves dropped, not patched
            "patchDroppedDense": 0,  # of those, dense patches that raised
            "patchDroppedSparse": 0,  # and sparse rows that changed bucket
            "hybridEvals": 0,      # write-side hysteresis ticks
            "applySeconds": 0.0,   # host wall time of the batch applies
            "remoteBatches": 0,    # replica envelopes sent
            "remoteMutations": 0,  # mutations those envelopes carried
            "newShards": 0,        # shards created by batched Sets
            "hintedMutations": 0,  # batched mutations hinted for a replica
        }

    def clear_caches(self) -> None:
        """Drop every resident leaf, cached result, leaf statistic and TopN
        merge (index/field deletion: a recreated schema object restarts its
        generations and versions)."""
        self.residency.clear()
        if self.plan_cache is not None:
            self.plan_cache.clear()
        self.hybrid.clear_stats()
        with self._topn_memo_lock:
            self._topn_merge_memo.clear()

    def drop_field(self, index_name: str, field_name: str) -> None:
        """Drop what the executor keeps of a deleted field: its resident
        leaves and slabs, the plan-cache entries keyed by any of its rows,
        its heat entries, row forms and TopN merges."""
        self.residency.drop_where(
            lambda k: len(k) > 2 and k[1] == index_name
            and k[2] == field_name)
        if self.plan_cache is not None:

            def cached_on_field(k: tuple) -> bool:
                k = k[1:] if k[0] == "count" else k
                return k[0] == index_name and any(
                    g[1] == field_name for g in k[3])

            self.plan_cache.drop_where(cached_on_field)
        if self.heat is not None:
            self.heat.drop_field(index_name, field_name)
        self.hybrid.drop_field(index_name, field_name)
        with self._topn_memo_lock:
            for k in [k for k in self._topn_merge_memo
                      if k[:2] == (index_name, field_name)]:
                del self._topn_merge_memo[k]

    def drop_shards(self, index_name: str, shards) -> None:
        """Drop what the executor keeps over fragments that were deleted (a
        resize moved their shards away): every resident leaf, cached
        result and TopN merge of the index whose shard set holds one of
        them. A fragment made again later starts its generations over, so
        a kept entry could match the new one's key with other bits."""
        shards = frozenset(shards)

        def over_shard(k: tuple) -> bool:
            k = k[1:] if k and k[0] == "count" else k
            return index_name in k[:2] and any(
                isinstance(e, tuple) and any(
                    type(x) is int and x in shards for x in e) for e in k)

        self.residency.drop_where(over_shard)
        if self.plan_cache is not None:
            self.plan_cache.drop_where(over_shard)
        with self._topn_memo_lock:
            for k in [k for k in self._topn_merge_memo
                      if k[0] == index_name
                      and not shards.isdisjoint(k[2])]:
                del self._topn_merge_memo[k]

    # ------------------------------------------------------------------ API

    def execute(self, index_name: str, query,
                shards: Optional[list[int]] = None, remote: bool = False,
                timeout: Optional[float] = None) -> list:
        """Execute PQL; returns one result per call. An envelope of
        Set/Clear calls only goes through the IngestBatcher while
        PILOSA_TPU_TORCH_INGEST is not 0 (a remote=True one, a
        coordinator's replica envelope, is applied directly); what it
        declines runs per bit. remote=True marks a fan-out sub-request:
        it runs here on exactly the given shards, and its results stay
        ids. `timeout` seconds set the query's deadline (an inherited one
        applies otherwise)."""
        if isinstance(query, str):
            # the linear mutation scanner first: bulk envelopes of unique
            # columns would only churn the parse cache
            query = parse_mutations_fast(query) or parse_string_cached(query)
        if not isinstance(query, Query):
            raise TypeError("query must be a PQL string or Query")
        index = self.holder.index(index_name)
        if index is None:
            raise ExecutionError(f"index not found: {index_name}")
        if remote and self.read_fence and self.cluster is not None:
            self._check_remote_fence(index_name, query, shards)
        distributed = not remote and self._clustered()
        if (query.calls and ingest_env_enabled()
                and all(c.name in ("Set", "Clear") for c in query.calls)):
            handled = (self._execute_ingest_remote(index, query) if remote
                       else self._execute_ingest(index, query))
            if handled is not None:
                return handled
        if not distributed and len(query.calls) > 1 and all(
                c.name in ("SetRowAttrs", "SetColumnAttrs")
                for c in query.calls):
            return self._execute_attrs_bulk(index, query.calls)
        dl_token = (qctx.deadline.set(time.monotonic() + timeout)
                    if timeout else None)
        prof = qprofile.current_profile.get()
        results = []
        # one read fence over a local query's calls; a distributed one
        # takes it around this node's share only, never across an RPC
        fence = (contextlib.nullcontext() if distributed
                 else self._fence(index.name).read())
        try:
            with fence:
                for call in query.calls:
                    qctx.check()
                    results.append(self._run_call(index, call, shards,
                                                  remote, distributed, prof))
        finally:
            if dl_token is not None:
                qctx.deadline.reset(dl_token)
        return results

    # -- the rejoin read fence (:384-480) ------------------------------------

    def fence_reads(self, keys) -> int:
        """Fence (index, shard) pairs; returns how many were new."""
        with self._fence_lock:
            before = len(self.read_fence)
            self.read_fence.update(keys)
            return len(self.read_fence) - before

    def unfence_reads(self, key) -> bool:
        with self._fence_lock:
            if key in self.read_fence:
                self.read_fence.discard(key)
                return True
            return False

    def fence_snapshot(self) -> dict:
        with self._fence_lock:
            return {"fencedShards": len(self.read_fence),
                    "rerouted": self.fence_rerouted,
                    "refusedRemote": self.fence_refused,
                    "servedStale": self.fence_served_stale}

    def _fence_peer(self, index_name: str, shard: int):
        """A live replica of the shard on another node, or None."""
        for n in self.cluster.shard_nodes(index_name, shard):
            if n.id != self.cluster.local_id and n.uri \
                    and not self.cluster.is_unavailable(n.id):
                return n
        return None

    def _check_remote_fence(self, index_name: str, query: Query,
                            shards) -> None:
        """A coordinator's read of fenced shards is refused (code
        read-fenced) while another replica is live, so its per-shard
        failover serves them there; with none live the stale copy here
        answers. Writes (hint replays, heals) pass."""
        if not shards:
            return
        if any(self._call_has_write(c) for c in query.calls):
            return
        with self._fence_lock:
            fenced = [s for s in shards
                      if (index_name, s) in self.read_fence]
        for s in fenced:
            if self._fence_peer(index_name, s) is not None:
                with self._fence_lock:
                    self.fence_refused += 1
                raise ExecutionError(
                    f"shard {s} read-fenced pending rejoin sync "
                    "(code=read-fenced)")
        if fenced:
            with self._fence_lock:
                self.fence_served_stale += len(fenced)

    def _fanout_groups(self, index: Index, qshards: list) -> dict:
        """shards_by_node with this node's fenced shards planned onto their
        next live replica (or kept here when none is live)."""
        groups = self.cluster.shards_by_node(index.name, qshards)
        if not self.read_fence:
            return groups
        local = groups.get(self.cluster.local_id)
        if not local:
            return groups
        with self._fence_lock:
            fenced = {s for s in local if (index.name, s) in self.read_fence}
        if not fenced:
            return groups
        keep = [s for s in local if s not in fenced]
        for s in sorted(fenced):
            peer = self._fence_peer(index.name, s)
            with self._fence_lock:
                if peer is None:
                    self.fence_served_stale += 1
                else:
                    self.fence_rerouted += 1
            if peer is None:
                keep.append(s)
            else:
                groups.setdefault(peer.id, []).append(s)
        if keep:
            groups[self.cluster.local_id] = sorted(keep)
        else:
            groups.pop(self.cluster.local_id, None)
        return groups

    def _run_call(self, index: Index, call: Call, shards, remote: bool,
                  distributed: bool, prof):
        self.stats.count(f"query/{call.name}")
        t_call = time.perf_counter() if prof is not None else 0.0
        with self.tracer.start_span(f"executor.{call.name}") as span:
            if distributed:
                result = self._execute_distributed(index, call, shards)
            else:
                result = self._local_call(index, call, shards)
            if not remote:
                # ids -> keys on the coordinator only
                result = self._translate_result(index, call, result)
            span.set_tag("index", index.name)
        if prof is not None:
            prof.record_call(call.name, (time.perf_counter() - t_call) * 1e3)
        return result

    def _clustered(self) -> bool:
        return (self.cluster is not None and self.client is not None
                and len(self.cluster.nodes) > 1)

    def _local_call(self, index: Index, call: Call, shards):
        """A call on this node's shards, under the index's read fence."""
        with self._fence(index.name).read():
            return self._execute_call(index, call, shards)

    def _fence(self, index_name: str) -> ApplyFence:
        """The index's ApplyFence: reads share it, a batch apply (with its
        patches) holds it alone."""
        fence = self._fences.get(index_name)
        if fence is None:
            with self._ingest_lock:
                fence = self._fences.setdefault(index_name, ApplyFence())
        return fence

    def _execute_call(self, index: Index, call: Call, shards):
        """Plan the call, install its plan node for the evaluation to fill
        (cache events, hybrid choices, the actual cardinality) and record
        it on the profile, then dispatch (executor.py:573-594). Options()
        wraps its child before planning."""
        if call.name == "Options":
            return self._execute_options(index, call, shards)
        plan_tok = None
        if self.planner is not None and call.name in planner.PLANNED_CALLS:
            call, plan_info = self.planner.plan_call(
                index, call, self._query_shards(index, shards))
            plan_tok = planner.current_plan.set(plan_info)
            prof = qprofile.current_profile.get()
            if prof is not None:
                prof.record_plan(plan_info)
        try:
            return self._dispatch_call(index, call, shards)
        finally:
            if plan_tok is not None:
                planner.current_plan.reset(plan_tok)

    def _dispatch_call(self, index: Index, call: Call, shards):
        if call.name == "Count":
            return self._execute_count(index, call, shards)
        if call.name == "Sum":
            return self._execute_sum(index, call, shards)
        if call.name in ("Min", "Max"):
            return self._execute_min_max(index, call, shards,
                                         is_min=call.name == "Min")
        if call.name == "Set":
            return self._execute_set(index, call)
        if call.name == "Clear":
            return self._execute_clear(index, call)
        if call.name == "ClearRow":
            return self._execute_clear_row(index, call)
        if call.name == "SetRowAttrs":
            return self._execute_set_row_attrs(index, call)
        if call.name == "SetColumnAttrs":
            return self._execute_set_column_attrs(index, call)
        if call.name == "Store":
            return self._execute_store(index, call, shards)
        if call.name == "TopN":
            return self._execute_topn(index, call, shards)
        if call.name == "Rows":
            return self._execute_rows(index, call, shards)
        if call.name == "GroupBy":
            return self._execute_group_by(index, call, shards)
        if call.name in BITMAP_CALLS:
            return self._execute_bitmap_call(index, call, shards)
        raise NotPortedError(f"call {call.name}() not ported yet")

    def _query_shards(self, index: Index, shards) -> list[int]:
        if shards is not None:
            return sorted(shards)
        return index.available_shards_list()

    # ----------------------------------------------------- bitmap programs

    @staticmethod
    def _field(index: Index, field_name: str):
        f = index.field(field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        return f

    def _translate_row(self, index: Index, f, value,
                       create: bool = True) -> Optional[int]:
        """A row argument -> its id: a bool row is 1 or 0, a string a key
        of the field (None: unknown and create is False)
        (executor.py:2472-2480)."""
        if isinstance(value, bool):
            return 1 if value else 0
        if isinstance(value, str):
            if self.translator is None:
                raise ExecutionError("string keys require a translator")
            return _minted(self.translator.translate_row(
                index.name, f.name, value, create=create), value, create)
        return int(value)

    def _translate_col(self, index: Index, value,
                       create: bool = True) -> Optional[int]:
        """A column argument -> its id; a string is a key of the index
        (executor.py:2463-2470)."""
        if isinstance(value, str):
            if self.translator is None:
                raise ExecutionError("string keys require a translator")
            return _minted(self.translator.translate_column(
                index.name, value, create=create), value, create)
        if value is None:
            raise ExecutionError("a column is required")
        return int(value)

    def _read_row_id(self, index: Index, c: Call) -> tuple:
        """(field, row id) of a read's Row or time Range argument, the id
        None for an unknown key (a read mints nothing)."""
        f = self._field(index, c.field_arg())
        return f, self._translate_row(index, f, c.args[f.name], create=False)

    @staticmethod
    def _leaf_gens(index: Index, field_name: str, view_name: str, shards,
                   row_id: int) -> tuple:
        """Per-shard generations of one row, () without the view: the
        version part of a plan-cache key (executor.py:626)."""
        f = index.field(field_name)
        view = f.view(view_name) if f is not None else None
        if view is None:
            return ()
        out = []
        for s in shards:
            frag = view.fragment(s)
            out.append(0 if frag is None else frag.row_generation(row_id))
        return tuple(out)

    @staticmethod
    def _fragments(index: Index, field_name: str, view_name: str,
                   shards: list) -> list:
        f = index.field(field_name)
        view = f.view(view_name) if f is not None else None
        return [None if view is None else view.fragment(s) for s in shards]

    def _charge_read(self, index: Index, field_name: str, view_name: str,
                     shards_t: tuple) -> None:
        """The read charge of one row leaf over its shard set (every leaf
        read, resident or not: executor.py:656-663)."""
        tracker = self.heat
        if tracker is not None and tracker.enabled:
            tracker.touch_many(_heat.Frags(index.name, field_name,
                                           view_name, shards_t), reads=1)

    def _row_leaf_dev(self, index: Index, field_name: str, shards: list,
                      row_id: int, view_name: str = VIEW_STANDARD,
                      frags: Optional[list] = None,
                      gens: Optional[tuple] = None):
        """Device-resident [S, W] leaf of one row, keyed by the per-shard
        row generations (a write changes the key). On a miss, a resident
        sparse or run twin under the same generations is expanded on the
        device; only without one is the plane built from the host."""
        if frags is None:
            frags = self._fragments(index, field_name, view_name, shards)
        if gens is None:
            gens = tuple(0 if fr is None else fr.row_generation(row_id)
                         for fr in frags)
        shards_t = tuple(shards)
        key = ("row", index.name, field_name, view_name, row_id, shards_t,
               gens)
        self._charge_read(index, field_name, view_name, shards_t)

        def make():
            twin = self._dense_from_twin(index, field_name, view_name,
                                         shards, row_id, frags, gens)
            if twin is not None:
                return twin
            out = np.zeros((len(shards), WORDS_PER_SHARD), dtype=np.uint32)
            for i, fr in enumerate(frags):
                if fr is not None:
                    fr.row_dense(row_id, out[i])
            self.hybrid.record_upload("dense", out.nbytes)
            return out

        return self.residency.leaf(key, make)

    def _dense_from_twin(self, index: Index, field_name: str, view_name: str,
                         shards: list, row_id: int, frags: list, gens: tuple):
        """The row's plane expanded on the device from its resident sparse
        or run leaf under `gens`, or None. Only the form the chooser last
        picked for the row is probed (executor.py:665-696 probes both,
        reading the run statistics of every dense row it builds)."""
        hyb = self.hybrid
        if not hyb.active():
            return None
        last = hyb.last((index.name, field_name, view_name, row_id))
        if last == "sparse":
            stat = max((fr.row_cardinality(row_id) for fr in frags
                        if fr is not None), default=0)
        elif last == "run":
            stat = max((fr.row_interval_count(row_id) for fr in frags
                        if fr is not None), default=0)
        else:
            return None
        twin = self.residency.peek(
            (last, index.name, field_name, view_name, row_id, tuple(shards),
             hyb.pad_slots(max(stat, 1)), gens))
        if twin is None:
            return None
        hyb.record_materialize()
        if last == "sparse":
            return hy.sparse_to_dense(twin)
        return hy.run_to_dense(twin)

    def _row_leaf_sparse_dev(self, index: Index, field_name: str,
                             view_name: str, shards: list, row_id: int,
                             frags: list, gens: tuple, slots: int):
        """Resident sparse leaf int32[S, slots]: each shard's sorted column
        ids, SPARSE_SENTINEL-padded (executor.py:785-827). A write racing
        the sizing read can overflow the slots; the row is then cut, as a
        dense row tears per shard, and the write's generation re-keys the
        next read."""
        shards_t = tuple(shards)
        key = ("sparse", index.name, field_name, view_name, row_id, shards_t,
               slots, gens)
        self._charge_read(index, field_name, view_name, shards_t)

        def make():
            arr = np.full((len(shards), slots), hy.SPARSE_SENTINEL,
                          dtype=np.int32)
            for i, fr in enumerate(frags):
                if fr is not None:
                    cols = fr.row_columns(row_id)
                    n = min(cols.size, slots)
                    arr[i, :n] = cols[:n]
            return arr

        return self.residency.leaf(key, make, self._put_index("sparse"))

    def _put_index(self, rep: str):
        """The upload of a sparse or run leaf's host array, counted as the
        chooser's upload of that form."""
        def put(arr: np.ndarray) -> torch.Tensor:
            self.hybrid.record_upload(rep, arr.nbytes)
            return self.runner.put_index_leaf(arr)
        return put

    def _row_leaf_run_dev(self, index: Index, field_name: str,
                          view_name: str, shards: list, row_id: int,
                          frags: list, gens: tuple, slots: int):
        """Resident run leaf int32[S, 2, slots]: each shard's intervals
        straight from its containers (Fragment.row_runs), RUN_SENTINEL-
        padded (executor.py:739-783)."""
        shards_t = tuple(shards)
        key = ("run", index.name, field_name, view_name, row_id, shards_t,
               slots, gens)
        self._charge_read(index, field_name, view_name, shards_t)

        def make():
            arr = np.full((len(shards), 2, slots), hy.RUN_SENTINEL,
                          dtype=np.int32)
            for i, fr in enumerate(frags):
                if fr is not None:
                    arr[i] = hy.runs_from_intervals(fr.row_runs(row_id),
                                                    slots)
            return arr

        return self.residency.leaf(key, make, self._put_index("run"))

    def _chosen_leaf(self, index: Index, field_name: str, shards: list,
                     row_id: int, call: Optional[Call] = None) -> tuple:
        """(leaf, kind) of one row in the form the chooser picks; with the
        Row `call`, the choice is recorded on the plan node."""
        rep, slots, frags, gens = planner.choose_representation(
            self.hybrid, index, field_name, VIEW_STANDARD, shards, row_id,
            call=call)
        if rep == "sparse":
            return self._row_leaf_sparse_dev(index, field_name, VIEW_STANDARD,
                                             shards, row_id, frags, gens,
                                             slots), rep
        if rep == "run":
            return self._row_leaf_run_dev(index, field_name, VIEW_STANDARD,
                                          shards, row_id, frags, gens,
                                          slots), rep
        return self._row_leaf_dev(index, field_name, shards, row_id,
                                  VIEW_STANDARD, frags, gens), "dense"

    def hybrid_snapshot(self) -> dict:
        """The chooser's counters with the resident leaves by form."""
        out = self.hybrid.snapshot()
        by_kind = self.residency.snapshot()["by_kind"]
        for name, kind in (("Sparse", "sparse"), ("Run", "run"),
                           ("DenseRow", "row")):
            k = by_kind.get(kind, {})
            out[f"resident{name}Leaves"] = k.get("entries", 0)
            out[f"resident{name}Bytes"] = k.get("bytes", 0)
        return out

    def _zeros_leaf(self, n_shards: int):
        """The resident empty [S, W] plane."""
        return self.residency.leaf(
            ("zeros", n_shards),
            lambda: np.zeros((n_shards, WORDS_PER_SHARD), dtype=np.uint32))

    def _compile(self, index: Index, call: Call, shards: list):
        """Walk the call tree -> (program, leaves, kinds): kinds[i] is
        "dense" ([S, W] int32 planes), "sparse" ([S, K] column ids) or
        "run" ([S, 2, R] intervals), the form the chooser picked for each
        row and existence leaf (Range masks and empty rows are dense)."""
        leaves: list = []
        kinds: list = []

        def leaf(t, kind: str = "dense"):
            leaves.append(t)
            kinds.append(kind)
            return ("leaf", len(leaves) - 1)

        def zeros():
            return leaf(self._zeros_leaf(len(shards)))

        def walk(c: Call):
            if c.name == "Row":
                f, row_id = self._read_row_id(index, c)
                if row_id is None:  # an unknown key: the empty row
                    return zeros()
                return leaf(*self._chosen_leaf(index, f.name, shards,
                                               row_id, c))
            if c.name in ("Union", "Xor"):
                if not c.children:  # zero-arg Union()/Xor(): empty row
                    return zeros()
                op = "or" if c.name == "Union" else "xor"
                return (op, *[walk(ch) for ch in c.children])
            if c.name in ("Intersect", "Difference"):
                if not c.children:
                    raise planner.empty_operand_error(c)
                op = "and" if c.name == "Intersect" else "andnot"
                return (op, *[walk(ch) for ch in c.children])
            if c.name == "Not":
                if len(c.children) != 1:
                    raise ExecutionError("Not() takes exactly one argument")
                if index.existence_field() is None:
                    raise ExecutionError(f"index {index.name} does not "
                                         "support existence tracking")
                ex = leaf(*self._chosen_leaf(index, EXISTENCE_FIELD_NAME,
                                             shards, 0))
                return ("andnot", ex, walk(c.children[0]))
            if c.name == "Range":
                if "_start" in c.args or "_end" in c.args:
                    return leaf(self._time_range_leaf_dev(index, c, shards))
                return leaf(self._range_leaf_dev(index, c, shards))
            raise ExecutionError(f"expected bitmap call, got {c.name}")

        program = walk(call)
        return program, leaves, kinds

    def _time_range(self, index: Index, c: Call) -> tuple:
        """(field, row id, views) of a time Range(f=row, start, end): the
        views are views_by_time_range's minimal cover of [start, end)
        (executor.py:1236-1252); a field without a quantum has none. The
        row id is None for an unknown key (the JAX package mints one
        here: ROADMAP Queue C)."""
        f, row_id = self._read_row_id(index, c)
        start, end = c.args.get("_start"), c.args.get("_end")
        if not isinstance(start, datetime) or not isinstance(end, datetime):
            raise ExecutionError("Range() requires start and end timestamps")
        return f, row_id, tuple(timequantum.views_by_time_range(
            VIEW_STANDARD, start, end, f.options.time_quantum))

    def _time_range_leaf_dev(self, index: Index, c: Call, shards: list):
        """Resident [S, W] plane of a time Range: the OR of the covered
        views' rows, built on the host (_materialize_range_call,
        executor.py:1622-1640) and keyed by every view's generations, so a
        write into any covered view changes the key."""
        f, row_id, views = self._time_range(index, c)
        if row_id is None:
            return self._zeros_leaf(len(shards))
        gens = tuple(self._leaf_gens(index, f.name, v, shards, row_id)
                     for v in views)
        key = ("timerange", index.name, f.name, row_id, views, tuple(shards),
               gens)

        def make():
            out = np.zeros((len(shards), WORDS_PER_SHARD), dtype=np.uint32)
            for v in views:
                for i, fr in enumerate(self._fragments(index, f.name, v,
                                                       shards)):
                    if fr is not None:
                        out[i] |= fr.row_dense(row_id)
            return out

        return self.residency.leaf(key, make)

    def _eval_program(self, program, leaves: list, kinds: list) -> tuple:
        """(kind, device result) of a compiled program: an all-dense one
        through row_leaves_dev, a hybrid one through eval_hybrid with the
        sparse∩dense (and sparse&~dense) nodes on the kernel."""
        if "sparse" not in kinds and "run" not in kinds:
            return "dense", self.runner.row_leaves_dev(leaves, program)
        with self._hybrid_timed(kinds, "eval_hybrid"):
            return hy.eval_hybrid(program, leaves, kinds, WORDS_PER_SHARD,
                                  kernels.sparse_intersect_dense,
                                  kernels.sparse_difference_dense)

    def _hybrid_timed(self, kinds: list, name: str):
        """A hybrid program timed as the "sparse" family, or "run" when it
        has no sparse leaf."""
        return telemetry.timed("sparse" if "sparse" in kinds else "run",
                               name, self.runner.device, len(kinds))

    def _eval_program_dense(self, program, leaves: list,
                            kinds: list) -> torch.Tensor:
        """[S, W] device result of a compiled program; a sparse or run root
        is expanded to planes (executor.py:1384-1403)."""
        kind, arr = self._eval_program(program, leaves, kinds)
        if kind == "sparse":
            self.hybrid.record_materialize()
            return hy.sparse_to_dense(arr)
        if kind == "run":
            self.hybrid.record_materialize()
            return hy.run_to_dense(arr)
        return arr

    def _plan_cache_key(self, index: Index, call: Call,
                        shards: list) -> Optional[tuple]:
        """The plan-cache key of a bitmap subtree, or None while the cache
        is off or the shape cannot be keyed."""
        pc = self.plan_cache
        if (pc is None or not pc.enabled or call.name not in BITMAP_CALLS
                or planner.is_empty_call(call)):
            return None
        return planner.subtree_cache_key(self, index, call, shards)

    def _composed_row(self, index: Index, call: Call, shards: list,
                      sparse_root: bool = False) -> tuple:
        """(kind, device result) of a bitmap call tree through the plan
        cache (executor.py:1333-1382): a hit returns the cached [S, W]
        result, heating the tree's fragments as a read; a miss evaluates
        and caches the planes. With the cache off or the shape unkeyable
        and `sparse_root`, a sparse or run root comes back as it is."""
        pc = self.plan_cache
        key = self._plan_cache_key(index, call, shards)
        epoch = 0
        if key is not None:
            epoch = pc.epoch
            hit = pc.get(key)
            planner.record_cache_event(call, hit is not None)
            if hit is not None:
                self._heat_call_touch(index, call, shards)
                return "dense", hit
        with _charged():
            program, leaves, kinds = self._compile(index, call, shards)
            if key is None and sparse_root:
                return self._eval_program(program, leaves, kinds)
            dev = self._eval_program_dense(program, leaves, kinds)
        if key is not None:
            pc.put(key, dev, dev.nbytes, epoch=epoch)
        return "dense", dev

    def _composed_row_dev(self, index: Index, call: Call, shards: list):
        """[S, W] device result of a bitmap call tree (a Sum/Min/Max or
        GroupBy filter, a TopN Src)."""
        return self._composed_row(index, call, shards)[1]

    def _heat_call_touch(self, index: Index, call: Call, shards) -> None:
        """One read charge of every fragment under a bitmap call tree, on
        a plan-cache hit (executor.py:1414-1453): the hit never reaches
        the leaf reads, and the caller still read exactly these
        fragments. Row: the standard view; Range: the BSI view, or a time
        Range's standard view (as the JAX package approximates it); Not:
        the existence row."""
        tracker = self.heat
        if tracker is None or not tracker.enabled:
            return
        pairs: list = []

        def walk(c: Call) -> None:
            if c.name == "Row":
                pairs.append((c.field_arg(), VIEW_STANDARD))
            elif c.name == "Range":
                cond = [k for k, v in c.args.items()
                        if isinstance(v, Condition)]
                if cond:
                    pairs.append((cond[-1], VIEW_BSI_PREFIX + cond[-1]))
                else:
                    pairs.append((c.field_arg(), VIEW_STANDARD))
            elif c.name == "Not":
                pairs.append((EXISTENCE_FIELD_NAME, VIEW_STANDARD))
            for ch in c.children:
                walk(ch)

        walk(call)
        now = time.monotonic()  # one clock for the whole charge
        shards_t = tuple(shards)
        for field_name, view_name in pairs:
            tracker.touch_many(_heat.Frags(index.name, field_name, view_name,
                                           shards_t), reads=1, now=now)

    @staticmethod
    def _record_actual(count) -> None:
        """The result's cardinality on the executing plan node (the
        profile's estimate against actual)."""
        plan = planner.current_plan.get()
        if plan is not None:
            plan["actualCardinality"] = int(count)

    def _execute_bitmap_call(self, index: Index, call: Call, shards) -> Row:
        """A Row result: a planned-empty call reads nothing; a sparse root
        not cached gives its columns straight from the index array,
        anything else comes from the planes."""
        shards = self._query_shards(index, shards)
        if planner.is_empty_call(call):
            return Row()
        kind, arr = self._composed_row(index, call, shards, sparse_root=True)
        if kind == "sparse":
            host = (arr.gather() if is_blocked(arr) else arr).cpu().numpy()
            per_shard = [r[r < hy.SPARSE_SENTINEL].astype(np.int64)
                         for r in host]
        else:
            if kind == "run":
                arr = hy.run_to_dense(arr)
            per_shard = columns_from_planes(arr)
        out = Row()
        n_cols = 0
        for shard, cols in zip(shards, per_shard):
            if cols.size:
                n_cols += cols.size
                out.segments[shard] = (cols.astype(np.uint64)
                                       + np.uint64(shard * SHARD_WIDTH))
        self._record_actual(n_cols)
        if call.name == "Row":
            # a top-level Row() carries its row's attributes
            # (executor.py:1473-1481)
            f, row_id = self._read_row_id(index, call)
            if row_id is not None:
                out.attrs = f.row_attrs.attrs(row_id)
        return out

    def _execute_count(self, index: Index, call: Call, shards) -> int:
        """Count of a bitmap call tree: 0 for an empty call (no leaf, no
        launch), else through the plan cache's ("count",) + key scalar
        (executor.py:1486-1521), else on the device."""
        if len(call.children) != 1:
            raise ExecutionError("Count() takes exactly one argument")
        child = call.children[0]
        if child.name in ("Union", "Xor") and not child.children:
            return 0
        shards = self._query_shards(index, shards)
        key = self._plan_cache_key(index, child, shards)
        pc = self.plan_cache
        epoch = 0
        if key is not None:
            key = ("count",) + key  # apart from the subtree's row result
            epoch = pc.epoch
            cached = pc.get(key)
            planner.record_cache_event(child, cached is not None)
            if cached is not None:
                self._heat_call_touch(index, child, shards)
                self._record_actual(cached)
                return cached
        n = self._count_device(index, child, shards)
        if key is not None:
            pc.put(key, int(n), PlanCache.SCALAR_COST, epoch=epoch)
        self._record_actual(n)
        return n

    def _count_device(self, index: Index, child: Call, shards: list) -> int:
        """Count of a compiled tree on the device: a hybrid program
        through hybrid_count, a 1- or 2-leaf dense one through the
        CountBatcher, anything else through program_count."""
        program, leaves, kinds = self._compile(index, child, shards)
        if "sparse" in kinds or "run" in kinds:
            # before the batcher: its kernels read only [S, W] planes
            with _charged(), self._hybrid_timed(kinds, "hybrid_count"):
                return hy.hybrid_count(program, leaves, kinds,
                                       WORDS_PER_SHARD,
                                       kernels.sparse_intersect_dense,
                                       kernels.sparse_difference_dense)
        if self.batcher is not None:
            # concurrent Counts coalesce into one pair-stream launch (the
            # batcher charges each query its share)
            if program == ("leaf", 0) and len(leaves) == 1:
                return self.batcher.count("id", leaves[0], None)
            if (len(leaves) == 2 and len(program) == 3
                    and program[0] in _BATCHABLE_OPS
                    and program[1] == ("leaf", 0)
                    and program[2] == ("leaf", 1)):
                return self.batcher.count(program[0], leaves[0], leaves[1])
        with _charged():
            return self.runner.count_total_leaves(leaves, program)

    # ------------------------------------------------------------------ BSI

    def _bsi_field(self, index: Index, field_name: str):
        f = index.field(field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        if f.options.type != "int":
            raise ExecutionError(f"field {field_name} is not an int field")
        return f

    def _bsi_state(self, index: Index, f, shards: list) -> tuple:
        """(fragments, gens) of an int field's BSI view: gens[r] is the
        per-shard generation tuple of row r, r in 0..depth (the not-null
        row last). Every BSI residency key carries all of them, so any
        write to the field changes the key."""
        frags = self._fragments(index, f.name, f.bsi_view_name, shards)
        gens = tuple(tuple(0 if fr is None else fr.row_generation(r)
                           for fr in frags)
                     for r in range(f.bit_depth + 1))
        return frags, gens

    def _bsi_exists(self, index: Index, f, shards: list, state: tuple):
        frags, gens = state
        return self._row_leaf_dev(index, f.name, shards, f.bit_depth,
                                  f.bsi_view_name, frags, gens[-1])

    def _bsi_planes(self, index: Index, f, shards: list, state: tuple):
        """The field's [D, S, W] plane slab, resident under the generations
        of all D planes and the not-null row. A write rebuilds the whole
        slab from the host rows (the JAX package patches no slab either)."""
        frags, gens = state
        depth = f.bit_depth

        def make():
            out = np.zeros((depth, len(shards), WORDS_PER_SHARD),
                           dtype=np.uint32)
            for j, fr in enumerate(frags):
                if fr is not None:
                    for i in range(depth):
                        out[i, j] = fr.row_dense(i)
            return self.runner.put_plane_slab(out)

        key = ("bsiplanes", index.name, f.name, depth, tuple(shards), gens)
        return self.residency.leaf(key, make)

    def _range_leaf_dev(self, index: Index, c: Call, shards: list):
        """Resident [S, W] mask of a Range(v op x) condition, keyed by the
        condition and every generation of the field's BSI rows."""
        cond_field, cond = None, None
        for k, v in c.args.items():
            if isinstance(v, Condition):
                cond_field, cond = k, v
        if cond is None:
            raise ExecutionError("Range() requires a condition or time bounds")
        f = self._bsi_field(index, cond_field)
        state = self._bsi_state(index, f, shards)
        val = (tuple(cond.value) if isinstance(cond.value, list)
               else cond.value)
        key = ("bsicmp", index.name, cond_field, cond.op, val, f.bit_depth,
               tuple(shards), state[1])
        return self.residency.leaf(
            key, lambda: self._bsi_compare_dev(index, f, cond, shards, state))

    def _bsi_compare_dev(self, index: Index, f, cond: Condition,
                         shards: list, state: tuple):
        """[S, W] device mask of the columns satisfying `cond`. The
        out-of-range clamps (pilosa_tpu/executor.py:1709-1751) answer
        without a kernel; the rest is one bsi_compare launch, two for
        BETWEEN (GTE & LTE)."""
        depth, lo_f, hi_f, base = (f.bit_depth, f.options.min, f.options.max,
                                   f.base)
        # the not-null row, then the slab, before any clamp: the JAX
        # package's order (_bsi_planes), so both read and upload alike
        exists = self._bsi_exists(index, f, shards, state)
        planes = self._bsi_planes(index, f, shards, state)
        op = cond.op

        def empty():
            return self.runner.put_leaf(
                np.zeros((len(shards), WORDS_PER_SHARD), dtype=np.uint32))

        def sweep(value: int, bop: str):
            return bsi.compare(planes, exists, bsi.value_to_bits(value, depth),
                               bop)

        if op == NEQ and cond.value is None:  # != null: the not-null row
            return exists
        if op == BETWEEN:
            lo, hi = cond.int_slice_value()
            if hi < lo_f or lo > hi_f:
                return empty()
            if lo <= lo_f and hi >= hi_f:
                return exists
            return band(sweep(max(lo - base, 0), bsi.GTE),
                        sweep(min(hi, hi_f) - base, bsi.LTE))
        value = cond.value
        if isinstance(value, bool) or not isinstance(value, int):
            raise ExecutionError(
                "Range(): conditions only support integer values")
        if op not in _BSI_OPS:
            raise ExecutionError(f"unsupported condition op: {op}")
        if op in (GT, GTE) and value > hi_f:
            return empty()
        if op in (LT, LTE) and value < lo_f:
            return empty()
        if op == EQ and (value < lo_f or value > hi_f):
            return empty()
        if op == NEQ and (value < lo_f or value > hi_f):
            return exists
        if (op == LT and value > hi_f) or (op == LTE and value >= hi_f):
            return exists
        if (op == GT and value < lo_f) or (op == GTE and value <= lo_f):
            return exists
        return sweep(min(max(value - base, 0), hi_f - base), _BSI_OPS[op])

    def _bsi_inputs(self, index: Index, call: Call, shards):
        """(field, shards, planes, candidate) of Sum/Min/Max: candidate is
        the not-null row, ANDed on the device with the optional filter
        child composed through row_leaves_dev."""
        field_name = call.args.get("field")
        if field_name is None:
            raise ExecutionError(f"{call.name}(): field required")
        f = self._bsi_field(index, field_name)
        shards = self._query_shards(index, shards)
        state = self._bsi_state(index, f, shards)
        planes = self._bsi_planes(index, f, shards, state)
        cand = self._bsi_exists(index, f, shards, state)
        if call.children:
            cand = band(cand, self._composed_row_dev(index, call.children[0],
                                                     shards))
        return f, shards, planes, cand

    def _execute_sum(self, index: Index, call: Call, shards) -> ValCount:
        f, _, planes, cand = self._bsi_inputs(index, call, shards)
        if self.sum_batcher is not None:
            # concurrent Sums over this slab coalesce into one launch
            totals = self.sum_batcher.plane_sums(planes, cand)
        else:
            totals = (kernels.bsi_sum_counts(planes, cand).cpu().numpy()
                      .astype(np.int64).sum(axis=1))
        n = int(totals[-1])
        return ValCount(bsi.counts_to_sum(totals[:-1]) + f.base * n, n)

    def _execute_min_max(self, index: Index, call: Call, shards,
                         is_min: bool) -> ValCount:
        f, shards, planes, cand = self._bsi_inputs(index, call, shards)
        if self.minmax_batcher is not None:
            # concurrent descents over this slab share one batched descent
            packed = self.minmax_batcher.packed(planes, cand, is_min)
        else:
            fn = bsi.bsi_min_packed if is_min else bsi.bsi_max_packed
            with telemetry.timed("bsi", fn.__name__, self.runner.device, 2):
                packed = fn(planes, cand).cpu().numpy().astype(np.int64)
        bits, cnt = packed[:-1], packed[-1]
        best_val, best_cnt = None, 0
        for i in range(len(shards)):
            if cnt[i] == 0:
                continue
            v = bsi.bits_to_value(bits[:, i]) + f.base
            if best_val is None or (v < best_val if is_min else v > best_val):
                best_val, best_cnt = v, int(cnt[i])
            elif v == best_val:
                best_cnt += int(cnt[i])
        if best_val is None:
            return ValCount(0, 0)
        return ValCount(best_val, best_cnt)

    # ----------------------------------------------------------------- TopN

    def _execute_topn(self, index: Index, call: Call, shards) -> Pairs:
        """Two-phase TopN: rank-cache candidates, then exact counts of the
        winners (executor.py:1835-1922). Without a Src the cached counts
        pick the winners and container metadata recounts them; with one,
        the walk recounts |row & src| on the device."""
        field_name = call.args.get("_field")
        f = index.field(field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        # n=0 means unlimited, as does leaving it out
        n = call.uint_arg("n") or None
        shards = self._query_shards(index, shards)
        src = None
        if call.children:
            src = self._composed_row_dev(index, call.children[0], shards)
        ids_arg = call.uint_slice_arg("ids")
        threshold = call.uint_arg("threshold") or 0
        tanimoto = call.uint_arg("tanimotoThreshold") or 0
        # the row-attribute filter, only when both are given
        # (executor.py:1860-1892)
        attr_name = call.string_arg("attrName")
        attr_values = call.args.get("attrValues")
        allowed = None
        if attr_name and attr_values is not None:
            allowed = set(attr_values if isinstance(attr_values, list)
                          else [attr_values])

        def attr_ok(row_ids) -> list:
            attrs = f.row_attrs.attrs_many(row_ids)
            return [attrs.get(int(r), {}).get(attr_name) in allowed
                    for r in row_ids]

        if ids_arg is not None:
            ids = list(ids_arg)
            if allowed is not None:
                ids = [r for r, ok in zip(ids, attr_ok(ids)) if ok]
            if src is None:
                pairs = self._host_row_counts(f, shards, ids)
            else:
                pairs = self._exact_counts(index, f, shards, ids, src,
                                           tanimoto)
        else:
            cand_ids, cand_counts = self._topn_candidate_arrays(index, f,
                                                                shards)
            if allowed is not None:
                keep = np.asarray(attr_ok(cand_ids.tolist()), dtype=bool)
                cand_ids, cand_counts = cand_ids[keep], cand_counts[keep]
            if threshold:
                # a cached count bounds the row's final count from above
                keep = cand_counts >= threshold
                cand_ids, cand_counts = cand_ids[keep], cand_counts[keep]
            if src is not None:
                pairs = self._topn_src_walk(index, f, shards, cand_ids,
                                            cand_counts, src, n, tanimoto)
            else:
                # a row may be missing from some shard's cache, so the
                # winners are recounted
                winners = cand_ids[:n] if n is not None else cand_ids
                pairs = self._host_row_counts(f, shards, winners.tolist())
        if threshold:
            pairs = [(i, c) for i, c in pairs if c >= threshold]
        merged = merge_pairs([pairs])
        if n is not None and ids_arg is None:
            merged = merged[:n]
        return Pairs((i, c) for i, c in merged if c > 0)

    def _topn_candidate_arrays(self, index: Index, f, shards: list):
        """Merged (ids, cached counts) int64 arrays of the shards' rank
        caches, count desc then id asc (executor.py:1924-1966). An empty
        cache of a ranked field whose fragment holds bits is rebuilt in
        place; a field without caches has no candidates. The merge is
        memoized on the caches' versions."""
        view = f.view(VIEW_STANDARD)
        if view is None:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        per_shard, versions = [], []
        for s in shards:
            cache = view.rank_caches.get(s)
            if (cache is None or not len(cache)) and view.track_rank:
                frag = view.fragment(s)
                if frag is not None and frag.bit_count() > 0:
                    view.refresh_rank_cache(s)
                    cache = view.rank_caches.get(s)
            if cache is not None and len(cache):
                # version read before the arrays: a racing write makes the
                # tag stale, never the data sticky
                versions.append((s, cache._version))
                per_shard.append(cache.top_arrays())
        key = (index.name, f.name, tuple(shards))
        vt = tuple(versions)
        with self._topn_memo_lock:
            memo = self._topn_merge_memo.get(key)
            if memo is not None and memo[0] == vt:
                self._topn_merge_memo.move_to_end(key)
                return memo[1], memo[2]
        ids, counts = merge_pair_arrays(per_shard)
        with self._topn_memo_lock:
            self._topn_merge_memo[key] = (vt, ids, counts)
            self._topn_merge_memo.move_to_end(key)
            while len(self._topn_merge_memo) > TOPN_MEMO_ENTRIES:
                self._topn_merge_memo.popitem(last=False)
        return ids, counts

    def _recount(self, index: Index, f, shards: list, row_ids: list,
                 src) -> np.ndarray:
        """int64[3, len(row_ids)] of topn_counts_packed over the rows'
        resident leaves and src, TOPN_LAUNCH_ROWS leaves per launch, one
        fetch."""
        with telemetry.timed("topn", "topn_recount", self.runner.device,
                             len(row_ids) + 1):
            parts = []
            for start in range(0, len(row_ids), TOPN_LAUNCH_ROWS):
                leaves = [self._row_leaf_dev(index, f.name, shards, rid)
                          for rid in row_ids[start:start + TOPN_LAUNCH_ROWS]]
                parts.append(kernels.topn_counts_packed(leaves, src))
            with self._stats_lock:
                self.topn_recount_rows += len(row_ids)
            return torch.cat(parts, dim=1).cpu().numpy()

    def _topn_src_walk(self, index: Index, f, shards: list,
                       cand_ids: np.ndarray, cand_counts: np.ndarray, src,
                       n, tanimoto: int) -> list:
        """Ranking by |row & src| (executor.py:1968-2064). Where every
        fragment of the field is frozen, the sparse host path
        (_topn_src_sparse) counts every candidate from the stores' arrays;
        where it cannot (a dict store, or a candidate row the overlay
        touched) the walk goes densely, as in the JAX package: candidates
        in count-desc blocks of TOPN_BLOCK, recounted on the device,
        stopping once the next cached count (an upper bound of every
        remaining intersection) cannot beat the n-th best. Ties are exact
        on the host by (count, -row_id)."""
        view = f.view(VIEW_STANDARD)
        frags = [] if view is None else [view.fragment(s) for s in shards]
        # the src's columns per shard, read from the device only when the
        # sparse path can run
        src_cols, scount = None, 0
        if view is not None and cand_ids.size and all(
                fr is None or fr.frozen for fr in frags):
            src_cols = columns_from_planes(src)
        if tanimoto:
            # tanimoto > T/100 needs |row| in (|src| T/100, |src| 100/T):
            # rows outside the band are dropped unread, tested on exact
            # counts (a cached count can be short of a row's total)
            if src_cols is not None:
                scount = sum(c.size for c in src_cols)
            else:
                scount = int(kernels.topn_counts_packed([src], src)[2, 0])
            lo, hi = scount * tanimoto / 100, scount * 100 / tanimoto
            exact = self._host_row_count_arr(f, shards, cand_ids)
            keep = (exact > lo) & (exact < hi)
            cand_ids, cand_counts = cand_ids[keep], exact[keep]
        if view is None or cand_ids.size == 0:
            return []
        if src_cols is not None:
            sparse = self._topn_src_sparse(frags, cand_ids, cand_counts,
                                           src_cols, n, tanimoto, scount)
            if sparse is not None:
                return sparse
        pairs = list(zip(cand_ids.tolist(), cand_counts.tolist()))
        # min-heap of (count, -row_id): evicts the lowest count, then the
        # largest id, so the boundary keeps Pairs order
        heap: list = []
        out: list = []
        for start in range(0, len(pairs), TOPN_BLOCK):
            block = pairs[start:start + TOPN_BLOCK]
            if n is not None and len(heap) >= n and block[0][1] < heap[0][0]:
                break  # no remaining row can reach the top n
            packed = self._recount(index, f, shards,
                                   [rid for rid, _ in block], src)
            counts = packed[0]
            if tanimoto:
                keep = tanimoto_mask(packed[0], packed[1], packed[2, 0],
                                     tanimoto)
                counts = np.where(keep, counts, 0)
            block_pairs = [(rid, int(c))
                           for (rid, _), c in zip(block, counts.tolist())]
            if n is None:
                out.extend(block_pairs)
                continue
            for rid, c in block_pairs:
                if c <= 0:
                    continue
                item = (c, -rid)
                if len(heap) < n:
                    heapq.heappush(heap, item)
                elif item > heap[0]:
                    heapq.heapreplace(heap, item)
        if n is None:
            return out
        return [(-nrid, c) for c, nrid in heap]

    def _topn_src_sparse(self, frags: list, cand_ids: np.ndarray,
                         cand_counts: np.ndarray, src_cols: list, n,
                         tanimoto: int, scount: int):
        """The sparse host path of the Src ranking (executor.py:2066-2112):
        |row & src| of every candidate from the frozen stores' flat arrays
        (Fragment.rows_intersection_counts), linear in the candidates'
        stored bits, not candidates x the dense shard width: the regime of
        the reference's chemical-similarity search, where uniform
        fingerprint cardinalities defeat the count-bound pruning and every
        cached row is intersected. None where a fragment cannot take it
        (a candidate row touched by the overlay): the dense walk then
        answers."""
        totals = np.zeros(cand_ids.size, dtype=np.int64)
        with telemetry.timed("topn", "topn_src_sparse", _HOST,
                             cand_ids.size + 1):
            for frag, cols in zip(frags, src_cols):
                if frag is None:
                    continue
                got = frag.rows_intersection_counts(cand_ids, cols)
                if got is None:
                    return None
                totals += got
        with self._stats_lock:
            self.topn_recount_rows += int(cand_ids.size)
        keep = totals > 0
        if tanimoto:
            # cand_counts are exact here (the band recounted them); strict,
            # as the dense tanimoto_mask
            keep &= 100 * totals > tanimoto * (cand_counts + scount - totals)
        ids, counts = cand_ids[keep], totals[keep]
        if n is not None and ids.size > n:
            # top n by (count desc, id asc), as the dense walk's heap
            order = np.lexsort((ids, -counts))[:n]
            ids, counts = ids[order], counts[order]
        return list(zip(ids.tolist(), counts.tolist()))

    def _host_row_count_arr(self, f, shards: list, row_ids) -> np.ndarray:
        """Exact row counts summed over the shards, from container metadata
        (one Fragment.row_counts per shard)."""
        view = f.view(VIEW_STANDARD)
        totals = np.zeros(len(row_ids), dtype=np.int64)
        if view is not None:
            for s in shards:
                frag = view.fragment(s)
                if frag is not None:
                    totals += frag.row_counts(row_ids)
        return totals

    def _host_row_counts(self, f, shards: list, row_ids: list) -> list:
        totals = self._host_row_count_arr(f, shards, row_ids)
        return [(rid, int(c)) for rid, c in zip(row_ids, totals)]

    def _exact_counts(self, index: Index, f, shards: list, row_ids: list,
                      src, tanimoto: int) -> list:
        """|row & src| of the given rows through topn_counts_packed, zero
        where the strict Tanimoto mask drops them (executor.py:2133-2164)."""
        pairs = []
        for start in range(0, len(row_ids), TOPN_BLOCK):
            chunk = row_ids[start:start + TOPN_BLOCK]
            packed = self._recount(index, f, shards, chunk, src)
            counts = packed[0]
            if tanimoto:
                keep = tanimoto_mask(packed[0], packed[1], packed[2, 0],
                                     tanimoto)
                counts = np.where(keep, counts, 0)
            pairs.extend(zip(chunk, counts.tolist()))
        return pairs

    # ------------------------------------------------------- Rows / GroupBy

    def _execute_rows(self, index: Index, call: Call,
                      shards) -> RowIdentifiers:
        """Row ids with any bit, ascending, from `previous` + 1, at most
        `limit`, or those holding `column` (executor.py:2168-2215)."""
        field_name = call.args.get("_field") or call.args.get("field")
        f = index.field(field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        shards = self._query_shards(index, shards)
        limit = call.uint_arg("limit")
        previous = call.args.get("previous")
        if isinstance(previous, str):
            # keyed paging (executor.py:2175-2184): an unknown key is an
            # error, not a restart from the first row
            previous = self._translate_row(index, f, previous, create=False)
            if previous is None:
                raise ExecutionError(
                    f"row key not found: {call.args['previous']!r}")
        else:
            previous = call.uint_arg("previous")
        column = call.uint_arg("column")
        view = f.view(VIEW_STANDARD)
        out: set = set()
        start = previous + 1 if previous is not None else 0
        if view is not None:
            for s in shards:
                frag = view.fragment(s)
                if frag is None:
                    continue
                if column is not None:
                    if column // SHARD_WIDTH == s:
                        out.update(r for r in frag.rows_for_column(column)
                                   if r >= start)
                else:
                    # the global ascending first `limit` rows lie within
                    # the union of every shard's first `limit`
                    out.update(frag.row_ids(start=start, limit=limit))
        rows = sorted(out)
        if limit is not None:
            rows = rows[:limit]
        return RowIdentifiers(rows)

    def _rows_slab(self, index: Index, field_name: str, shards: list,
                   row_ids: list):
        """One resident [R, S, W] slab of a GroupBy axis, keyed by every
        row's per-shard generations, built row by row: a row whose dense
        leaf is resident under the same generations (a TopN recount made
        it) is copied on the device, any other from the host."""
        frags = self._fragments(index, field_name, VIEW_STANDARD, shards)
        gens = tuple(tuple(0 if fr is None else fr.row_generation(rid)
                           for fr in frags) for rid in row_ids)
        shards_t = tuple(shards)
        key = ("rows_slab", index.name, field_name, VIEW_STANDARD,
               shards_t, tuple(row_ids), gens)

        def make():
            runner = self.runner
            slab = runner.empty_slab(len(row_ids), len(shards),
                                     WORDS_PER_SHARD)
            for i, rid in enumerate(row_ids):
                leaf = self.residency.peek(("row", index.name, field_name,
                                            VIEW_STANDARD, rid, shards_t,
                                            gens[i]))
                if leaf is not None:
                    runner.set_slab_row(slab, i, leaf)
                    continue
                host = np.zeros((len(shards), WORDS_PER_SHARD),
                                dtype=np.uint32)
                for j, fr in enumerate(frags):
                    if fr is not None:
                        fr.row_dense(rid, host[j])
                runner.set_slab_row(slab, i, host)
            return slab

        return self.residency.leaf(key, make)

    def _count_sync(self) -> None:
        with self._stats_lock:
            self.groupby_host_syncs += 1

    @staticmethod
    def _chunk_for(slab) -> int:
        """Prefixes per GroupBy chunk (executor.py:2307-2309)."""
        r, s, w = slab.shape
        return int(min(512, max(16, (1 << 31) // max(1, r * s * w))))

    def _execute_group_by(self, index: Index, call: Call,
                          shards) -> GroupCounts:
        """GroupBy(Rows(...), ..., limit=, filter=) (executor.py:2217-2423):
        each Rows axis is one resident slab; level l counts every live
        prefix (an AND of one row per earlier axis) against axis l with the
        cross_count_matrix kernel, pruned to its nonzero groups on the
        device. A level's chunks are all launched before its one fetch; a
        limited last level probes its first chunk alone. Groups come out in
        the reference's lexicographic order. The port launches each chunk
        over its valid prefixes only (the JAX package pads to a static
        chunk and masks); the answers are the same."""
        shards = self._query_shards(index, shards)
        limit = call.uint_arg("limit")
        rows_calls = [c for c in call.children if c.name == "Rows"]
        if not rows_calls:
            raise ExecutionError("GroupBy requires at least one Rows() call")
        filt_calls = [c for c in call.children if c.name != "Rows"]
        named_filter = call.args.get("filter")
        if isinstance(named_filter, Call):
            filt_calls.append(named_filter)
        if len(filt_calls) > 1:
            raise ExecutionError("GroupBy supports at most one filter call")
        filt = None
        if filt_calls:
            filt = self._composed_row_dev(index, filt_calls[0], shards)

        axes = []
        for rc in rows_calls:
            fname = rc.args.get("_field") or rc.args.get("field")
            if index.field(fname) is None:
                raise ExecutionError(f"field not found: {fname}")
            row_ids = list(self._execute_rows(index, rc, shards))
            if not row_ids:
                return GroupCounts([])
            axes.append((fname, row_ids,
                         self._rows_slab(index, fname, shards, row_ids)))

        fname0, rows0, slab0 = axes[0]
        if len(axes) == 1:
            # per-row counts of slab0 & filter: one kernel pass, one fetch
            src = (filt if filt is not None
                   else self.runner.zeros_like_row(slab0))
            packed = kernels.topn_counts_packed(slab0, src).cpu().numpy()
            counts = packed[0] if filt is not None else packed[1]
            self._count_sync()
            live = np.nonzero(counts)[0]
            comb, counts = [live], counts[live]
        else:
            if filt is not None:
                slab0 = band(slab0, filt)
            axis_slabs = [slab0] + [a[2] for a in axes[1:]]
            comb = [np.arange(len(rows0))]
            for li in range(1, len(axes)):
                comb, counts = self._group_level(axis_slabs, comb, li,
                                                 axes[li][1], limit,
                                                 li == len(axes) - 1)
                if comb is None:
                    return GroupCounts([])

        results = []
        axis_rows = [a[1] for a in axes]
        axis_names = [a[0] for a in axes]
        for k in range(len(counts)):
            if limit is not None and len(results) >= limit:
                break  # before the append: limit=0 gives []
            results.append({
                "group": [{"field": axis_names[a],
                           "rowID": int(axis_rows[a][comb[a][k]])}
                          for a in range(len(comb))],
                "count": int(counts[k]),
            })
        return GroupCounts(results)

    def _group_level(self, axis_slabs: list, comb: list, li: int,
                     row_ids: list, limit, last: bool):
        """One level of the cross product -> (comb, counts) of its live
        groups, or (None, None) when none is live."""
        slab = axis_slabs[li]
        limited_last = last and limit is not None
        n_prefix, n_rows = len(comb[0]), len(row_ids)
        p_chunk = self._chunk_for(slab)
        bound = max(1, min(p_chunk * n_rows, self.groupby_live_cap))
        if limited_last:
            # the result is a lexicographic prefix: no chunk can add more
            # than `limit` groups, so a live set past the bound needs no
            # refetch
            bound = max(1, min(bound, limit))
        starts = list(range(0, n_prefix, p_chunk))
        # a limited last level probes its lex-first chunk alone
        waves = [starts[:1], starts[1:]] if limited_last else [starts]
        live_p, live_r, cvals = [], [], []
        found = 0
        for wave in waves:
            if not wave or (limited_last and found >= limit):
                continue
            pending = []
            for st in wave:
                en = min(st + p_chunk, n_prefix)
                idx = [ci[st:en] for ci in comb]
                pending.append((st, idx, self.runner.groupby_chunk(
                    axis_slabs[:li], idx, slab, en - st, bound)))
            # the wave's one blocking fetch
            fetched = torch.stack([
                torch.cat([n_live.view(1).to(torch.int64),
                           flat.to(torch.int64), cv.to(torch.int64)])
                for _, _, (n_live, flat, cv) in pending]).cpu().numpy()
            self._count_sync()
            for (st, idx, _), row in zip(pending, fetched):
                n_live = int(row[0])
                if n_live > bound and not (limited_last and bound >= limit):
                    # the chunk overflowed the bound: refetch its matrix
                    cmat = self.runner.groupby_cmat(
                        axis_slabs[:li], idx, slab, len(idx[0])).cpu().numpy()
                    self._count_sync()
                    lp, lr = np.nonzero(cmat)
                    cv = cmat[lp, lr]
                else:
                    k = min(n_live, bound)
                    fi = row[1:1 + k]
                    lp, lr = fi // n_rows, fi % n_rows
                    cv = row[1 + bound:1 + bound + k]
                live_p.append(lp.astype(np.int64) + st)
                live_r.append(lr.astype(np.int64))
                cvals.append(cv.astype(np.int64))
                found += lp.size
                if limited_last and found >= limit:
                    break  # lexicographic order: nothing later precedes
        if not live_p or sum(x.size for x in live_p) == 0:
            return None, None
        lp_all = np.concatenate(live_p)
        return ([ci[lp_all] for ci in comb] + [np.concatenate(live_r)],
                np.concatenate(cvals))

    # --------------------------------------------------------------- writes

    def _execute_set(self, index: Index, call: Call) -> bool:
        """Set (executor.py:2482-2500): a value on an int field, else a
        bit, into every view of a timestamped write on a time field; a
        mutex or bool field clears the column's other rows first."""
        col = self._translate_col(index, call.args.get("_col"))
        f = self._field(index, call.field_arg())
        if f.options.type == INT:
            changed = f.set_value(col, int(call.args[f.name]))
        else:
            changed = f.set_bit(self._translate_row(index, f,
                                                    call.args[f.name]),
                                col, timestamp=call.args.get("_timestamp"))
        index.mark_exists([col])
        self._heat_write(index, f, col)  # every Set, as executor.py:2499
        return changed

    def _execute_clear(self, index: Index, call: Call) -> bool:
        """Clear (executor.py:2514-2533): a bit in every view but the BSI
        one, or an int field's value; an unknown key clears nothing."""
        col = self._translate_col(index, call.args.get("_col"), create=False)
        f = self._field(index, call.field_arg())
        if col is None:
            return False
        if f.options.type == INT:
            changed = f.clear_value(col)
        else:
            row_id = self._translate_row(index, f, call.args[f.name],
                                         create=False)
            if row_id is None:
                return False
            changed = f.clear_bit(row_id, col)
        if changed:
            self._heat_write(index, f, col)
        return changed

    def _heat_write(self, index: Index, f, col: int) -> None:
        """The per-bit path's write charge of one column's fragment, at
        the BSI view for an int field (executor.py:2502-2512)."""
        tracker = self.heat
        if tracker is None or not tracker.enabled:
            return
        view = f.bsi_view_name if f.options.type == INT else VIEW_STANDARD
        tracker.touch(index.name, f.name, view, col // SHARD_WIDTH, writes=1)

    def _execute_clear_row(self, index: Index, call: Call) -> bool:
        """ClearRow(f=row) (executor.py:2535-2553): the row cleared in
        every fragment of every view but the BSI one, each changed
        fragment charged one write. As in the JAX package the rank caches
        are left as they are (a TopN recounts its winners). Durable:
        Fragment.clear_row logs to the WAL."""
        f = self._field(index, call.field_arg())
        row_id = self._translate_row(index, f, call.args[f.name],
                                     create=False)
        if row_id is None:
            return False
        tracker = self.heat
        changed = False
        for v in list(f.views.values()):
            if v.name.startswith(VIEW_BSI_PREFIX):
                continue
            for s, frag in list(v.fragments.items()):
                if frag.clear_row(row_id) > 0:
                    changed = True
                    if tracker is not None and tracker.enabled:
                        tracker.touch(index.name, f.name, v.name, s,
                                      writes=1)
        return changed

    def _execute_store(self, index: Index, call: Call, shards) -> bool:
        """Store(bitmap, f=row) (executor.py:2555-2577): the row replaced,
        over the query's shards, by the bitmap's columns; the field is
        created with the default options where it is missing. Durable:
        Fragment.set_row logs to the WAL."""
        if len(call.children) != 1:
            raise ExecutionError("Store() takes exactly one bitmap argument")
        field_name = call.field_arg()
        f = index.field(field_name)
        if f is None:
            f = index.create_field(field_name)
        row_id = self._translate_row(index, f, call.args[field_name])
        row = self._execute_bitmap_call(index, call.children[0], shards)
        view = f.create_view_if_not_exists(VIEW_STANDARD)
        qshards = self._query_shards(index, shards)
        tracker = self.heat
        if tracker is not None and tracker.enabled:
            tracker.touch_many(_heat.Frags(index.name, f.name, VIEW_STANDARD,
                                           tuple(qshards)), writes=1)
        empty = np.empty(0, dtype=np.uint64)
        for s in qshards:
            frag = view.create_fragment_if_not_exists(s)
            frag.set_row(row_id, row.segments.get(s, empty))
            view.refresh_rank_cache(s)
        f.add_available_shards(qshards)
        return True

    def _execute_options(self, index: Index, call: Call, shards):
        """Options(call, shards=[...], excludeColumns=, excludeRowAttrs=)
        (executor.py:3824-3836): the child over the given shards; the
        flags empty a Row result's columns or attributes."""
        if len(call.children) != 1:
            raise ExecutionError("Options() takes exactly one query argument")
        if call.args.get("shards") is not None:
            shards = [int(s) for s in call.uint_slice_arg("shards")]
        result = self._execute_call(index, call.children[0], shards)
        if call.bool_arg("excludeColumns") and isinstance(result, Row):
            result.segments = {}
        if call.bool_arg("excludeRowAttrs") and isinstance(result, Row):
            result.attrs = {}
        return result

    def _execute_set_row_attrs(self, index: Index, call: Call) -> None:
        """SetRowAttrs(f, row, k=v, ...) (executor.py:2579-2585): merged
        into the field's row attributes; a null value deletes its key."""
        f = self._field(index, call.args["_field"])
        row_id = self._translate_row(index, f, call.args["_row"])
        f.row_attrs.set_attrs(row_id, {k: v for k, v in call.args.items()
                                       if not k.startswith("_")})

    def _execute_set_column_attrs(self, index: Index, call: Call) -> None:
        """SetColumnAttrs(col, k=v, ...) (executor.py:2587-2590)."""
        col = self._translate_col(index, call.args.get("_col"))
        index.column_attrs.set_attrs(col, {k: v for k, v in call.args.items()
                                           if not k.startswith("_")})

    def _execute_attrs_bulk(self, index: Index, calls: list) -> list:
        """A query of SetRowAttrs and SetColumnAttrs calls only: keys
        translated in call order, then each store's merges applied in
        order in one commit (the JAX package commits per call; the stored
        attributes are the same)."""
        per_store: dict = {}
        for c in calls:
            self.stats.count(f"query/{c.name}")
            if c.name == "SetRowAttrs":
                f = self._field(index, c.args["_field"])
                store = f.row_attrs
                id_ = self._translate_row(index, f, c.args["_row"])
            else:
                store = index.column_attrs
                id_ = self._translate_col(index, c.args.get("_col"))
            per_store.setdefault(id(store), (store, []))[1].append(
                (id_, {k: v for k, v in c.args.items()
                       if not k.startswith("_")}))
        for store, items in per_store.values():
            store.set_bulk_attrs(items)
        return [None] * len(calls)

    def _translate_result(self, index: Index, call: Call, result):
        """Row ids -> keys on keyed fields (executor.py:2427-2461): TopN
        pairs, Rows and GroupBy groups, an Options-wrapped call's too. A
        row without a key renders as its decimal id, never "" (proto3
        would read an empty key as no key)."""
        if self.translator is None:
            return result
        while call.name == "Options" and call.children:
            call = call.children[0]

        def keyed(fname):
            f = index.field(fname) if fname else None
            return f is not None and f.options.keys

        def row_key(fname: str, rid: int) -> str:
            return (self.translator.translate_row_to_string(
                index.name, fname, int(rid)) or str(rid))

        if isinstance(result, Pairs):
            fname = call.args.get("_field")
            if keyed(fname):
                result.row_keys = [row_key(fname, rid) for rid, _ in result]
        elif isinstance(result, RowIdentifiers):
            fname = call.args.get("_field") or call.args.get("field")
            if keyed(fname):
                result.row_keys = [row_key(fname, rid) for rid in result]
        elif isinstance(result, GroupCounts):
            for gc in result:
                for fr in gc["group"]:
                    if keyed(fr.get("field")) and "rowID" in fr:
                        fr["rowKey"] = row_key(fr["field"], fr.pop("rowID"))
        return result

    # ------------------------------------------------ coalesced ingest

    def _ingest_mutation(self, index: Index, call: Call, fields: dict):
        """One Set/Clear -> a Mutation with its keys translated here, on
        the submitting thread (executor.py:3169-3210); False for a Clear
        of an unknown key (it changes nothing, as the per-bit path
        answers); None where only the per-bit path answers as it does: a
        missing field (its error), a field that is not a set field (int
        fields write per plane, mutex and bool fields clear other rows,
        time fields write time views), timestamps, and a set field holding
        views besides the standard one (an import-roaring can add them;
        the per-bit Clear clears every view, the batch apply only the
        standard one). `fields` caches field resolution across the
        envelope (False: not batchable). Minting is idempotent, so a later
        call's None sends the envelope per bit to the same ids."""
        args = call.args
        fname = None
        for k, v in args.items():  # call.field_arg(), without the raise
            if k[0] != "_" and not isinstance(v, Condition):
                fname = k
                break
        f = fields.get(fname)
        if f is None:
            if fname is None:
                return None
            f = index.field(fname)
            if (f is None or f.options.type != SET
                    or any(v != VIEW_STANDARD for v in f.views)):
                fields[fname] = False
                return None
            fields[fname] = f
        elif f is False:
            return None
        if args.get("_timestamp") is not None:
            return None
        col, row = args["_col"], args[fname]
        if type(col) is int and type(row) is int:  # the bulk case
            return Mutation(call.name == "Set", fname, row, col, call)
        create = call.name == "Set"
        col = self._translate_col(index, col, create=create)
        row = self._translate_row(index, f, row, create=create)
        if col is None or row is None:
            return False
        return Mutation(create, fname, row, col, call)

    def _ingest_prepare(self, index: Index, query: Query):
        """(slots, mutations) of an all-Set/Clear query, a slot being a
        resolved bool or an index into the mutations, or None for the
        per-bit path (executor.py:3212-3237)."""
        slots: list = []
        muts: list = []
        fields: dict = {}
        try:
            for call in query.calls:
                m = self._ingest_mutation(index, call, fields)
                if m is None:
                    return None
                if m is False:
                    slots.append(False)
                else:
                    slots.append(len(muts))
                    muts.append(m)
        except ExecutionError:
            raise
        except Exception:  # noqa: BLE001 — any oddity: the per-bit path decides
            return None
        return slots, muts

    @staticmethod
    def _ingest_unpack(slots: list, outcomes: list) -> list:
        """Per-call results of one request; the first error raises
        (executor.py:3239-3250)."""
        results = []
        for s in slots:
            if s is False:
                results.append(False)
                continue
            status, val = outcomes[s]
            if status == "err":
                raise val
            results.append(val)
        return results

    def _execute_ingest(self, index: Index, query: Query) -> Optional[list]:
        """Queue the query's mutations under the index's key and wait for a
        batch leader to apply them (executor.py:3252); None: the per-bit
        path serves the query."""
        prepared = self._ingest_prepare(index, query)
        if prepared is None:
            return None
        slots, muts = prepared
        if not muts:
            return list(slots)
        return self._ingest_unpack(slots,
                                   self.ingest.submit((index.name,), muts))

    def _apply_ingest_batch(self, index_name: str, muts: list) -> list:
        """The IngestBatcher's apply, on the batch leader's thread, under
        the QoS `batch` class: its pool submits and replica envelopes
        queue behind interactive traffic."""
        index = self.holder.index(index_name)
        if index is None:
            e = ExecutionError(f"index not found: {index_name}")
            return [("err", e)] * len(muts)
        tok = qos.current_priority.set("batch")
        try:
            if self._clustered():
                return self._apply_ingest_distributed(index, muts)
            return self._apply_fenced(index, muts)
        finally:
            qos.current_priority.reset(tok)

    def _apply_fenced(self, index: Index, muts: list) -> list:
        """_apply_ingest_local under the index's apply fence, timed."""
        with self._fence(index.name).apply():
            t0 = time.perf_counter()
            try:
                return self._apply_ingest_local(index, muts)
            finally:
                with self._ingest_lock:
                    self.ingest_stats["applySeconds"] += (
                        time.perf_counter() - t0)

    def _apply_ingest_local(self, index: Index, muts: list) -> list:
        """Apply one batch (executor.py:3429-3565): grouped per fragment,
        one Fragment.apply_batch each, then per changed row one rank-cache
        update and one hysteresis tick, existence marked through the same
        batch apply, the available shards once per field, and the resident
        leaves patched. Returns ("ok", changed) or ("err", exception) per
        mutation, in order. The port's set fields have only the standard
        view, which is all a Clear touches on the per-bit path too."""
        outcomes: list = [None] * len(muts)
        groups: dict = {}
        fields: dict = {}
        for mi, m in enumerate(muts):
            f = fields.get(m.field_name)
            if f is None:
                f = index.field(m.field_name)
                if f is None:
                    outcomes[mi] = ("err", ExecutionError(
                        f"field not found: {m.field_name}"))
                    continue
                fields[m.field_name] = f
            shard = m.shard
            if m.is_set:
                f.create_view_if_not_exists(VIEW_STANDARD) \
                    .create_fragment_if_not_exists(shard)
            else:
                view = f.view(VIEW_STANDARD)
                if view is None or view.fragment(shard) is None:
                    outcomes[mi] = ("ok", False)  # nothing to clear
                    continue
            groups.setdefault((m.field_name, shard), []).append((mi, m))
        hyb = self.hybrid
        # (field, view, row) -> {shard: [pre gen, post gen, net set local
        # columns, net cleared local columns]}: the residency patch input
        touched: dict = {}
        set_cols_by_shard: dict = {}
        set_shards: dict = {}
        # (field, view) -> ([shard], [write heat]): every Set charges, a
        # Clear only when it changed a bit (executor.py:3528-3540)
        write_heat: dict = {}
        hybrid_evals = 0
        for (fname, shard), items in groups.items():
            view = fields[fname].view(VIEW_STANDARD)
            frag = view.fragment(shard)
            pre = {m.row_id: frag.row_generation(m.row_id) for _, m in items}
            try:
                changed, wal_ops, wal_appends = frag.apply_batch(
                    [(m.is_set, m.row_id, m.col) for _, m in items])
            except Exception as e:  # noqa: BLE001 — fails this group only
                for mi, _m in items:
                    outcomes[mi] = ("err", e)
                continue
            net: dict = {}
            changed_rows: set = set()
            for (mi, m), ch in zip(items, changed):
                outcomes[mi] = ("ok", ch)
                if ch:
                    changed_rows.add(m.row_id)
                # last write wins per (row, column): the idempotent patch
                s_, c_ = net.setdefault(m.row_id, (set(), set()))
                lc = m.col % SHARD_WIDTH
                (s_ if m.is_set else c_).add(lc)
                (c_ if m.is_set else s_).discard(lc)
            for r in changed_rows:
                view._update_rank(shard, frag, r)
                touched.setdefault((fname, VIEW_STANDARD, r), {})[shard] = [
                    pre[r], frag.row_generation(r), net[r][0], net[r][1]]
            if hyb.active():
                for r in changed_rows:
                    row_key = (index.name, fname, VIEW_STANDARD, r)
                    prev = hyb.last(row_key)
                    if prev is None:
                        continue  # never chosen: the next read decides
                    card = frag.row_cardinality(r)
                    # the planner's rule (planner.py): intervals wherever
                    # the run band is reachable or the row is run now
                    read_runs = (prev == "run" or (card > hyb.threshold
                                                   and hyb.run_threshold > 0))
                    hyb.observe(row_key, card,
                                _heat.Frags(index.name, fname, VIEW_STANDARD,
                                            (shard,)),
                                run_stats=((frag.row_interval_count(r),)
                                           if read_runs else None))
                    hybrid_evals += 1
            w = sum(1 for (_mi, m), ch in zip(items, changed)
                    if m.is_set or ch)
            if w:
                wh = write_heat.setdefault((fname, VIEW_STANDARD), ([], []))
                wh[0].append(shard)
                wh[1].append(w)
            if any(m.is_set for _, m in items):
                set_shards.setdefault(fname, []).append(shard)
                set_cols_by_shard.setdefault(shard, set()).update(
                    m.col for _, m in items if m.is_set)
            with self._ingest_lock:
                st = self.ingest_stats
                st["appliedBatches"] += 1
                st["walAppends"] += wal_appends
                st["walOps"] += wal_ops
        self._charge_writes(index, write_heat)
        for fname, shards in set_shards.items():
            fields[fname].add_available_shards(shards)
        self._ingest_mark_exists(index, set_cols_by_shard, outcomes, muts)
        if touched:
            try:
                self._ingest_patch_residency(index, touched)
            except Exception:  # noqa: BLE001 — a patch never fails a write
                # the writes are durable and the generations re-key every
                # touched leaf: a failed patch costs a re-upload only
                with self._ingest_lock:
                    self.ingest_stats["patchDropped"] += 1
        n_err = sum(1 for o in outcomes if o is not None and o[0] == "err")
        with self._ingest_lock:
            self.ingest_stats["errors"] += n_err
            self.ingest_stats["hybridEvals"] += hybrid_evals
        return [o if o is not None else ("ok", False) for o in outcomes]

    def _charge_writes(self, index: Index, write_heat: dict) -> None:
        """One heat charge per (field, view) of a batch, each shard with
        its own write count."""
        tracker = self.heat
        if tracker is None or not tracker.enabled:
            return
        for (fname, vname), (shards, weights) in write_heat.items():
            order = np.argsort(shards, kind="stable")
            tracker.touch_many(
                _heat.Frags(index.name, fname, vname,
                            tuple(int(shards[i]) for i in order)),
                writes=np.asarray(weights)[order])

    def _ingest_mark_exists(self, index: Index, set_cols_by_shard: dict,
                            outcomes: list, muts: list) -> None:
        """Existence of the batch's Set columns through
        Fragment.apply_batch, one WAL append per existence fragment
        (executor.py:3567); the per-bit path pays one per Set. A failure
        fails that shard's Sets, as the per-bit mark_exists would."""
        if not set_cols_by_shard or not index.track_existence:
            return
        ef = index.existence_field()
        if ef is None:
            return
        ev = ef.create_view_if_not_exists(VIEW_STANDARD)
        marked = []
        for shard, cols in sorted(set_cols_by_shard.items()):
            efrag = ev.create_fragment_if_not_exists(shard)
            try:
                ech, wal_ops, wal_appends = efrag.apply_batch(
                    [(True, 0, c) for c in sorted(cols)])
            except Exception as e:  # noqa: BLE001 — fails this shard's Sets
                for mi, m in enumerate(muts):
                    if m.is_set and m.shard == shard:
                        outcomes[mi] = ("err", e)
                continue
            if any(ech):
                ev._update_rank(shard, efrag, 0)
            marked.append(shard)
            with self._ingest_lock:
                st = self.ingest_stats
                st["appliedBatches"] += 1
                st["walAppends"] += wal_appends
                st["walOps"] += wal_ops
        ef.add_available_shards(marked)

    def _ingest_patch_residency(self, index: Index, touched: dict) -> None:
        """Patch the resident leaves of the batch's changed rows instead of
        stranding them (executor.py:3600-3736): a dense leaf takes per-word
        set/clear masks, a sparse leaf sorted add/remove arrays while its
        row stays in its slot bucket; a run leaf, and a sparse leaf whose
        row changes bucket, are dropped. Every leaf key carries its row's
        generations, so a dropped or unmatched entry is re-uploaded
        correctly by its next read."""
        iname = index.name

        def parse(key):
            if not (isinstance(key, tuple) and key[1:2] == (iname,)):
                return None
            if key[0] == "row" and len(key) == 7:
                out = key[2], key[3], key[4], key[5], key[6], 0
            elif key[0] in ("sparse", "run") and len(key) == 8:
                out = key[2], key[3], key[4], key[5], key[7], key[6]
            else:
                return None
            if len(out[3]) != len(out[4]):
                return None
            return out

        def matcher(key) -> bool:
            p = parse(key)
            if p is None:
                return False
            fld, vw, row, shards_t, gens, _slots = p
            t = touched.get((fld, vw, row))
            if t is None:
                return False
            hit = False
            for s, g in zip(shards_t, gens):
                e = t.get(s)
                if e is not None:
                    if g != e[0]:
                        return False  # older than the batch: leave it
                    hit = True
            return hit

        def count(name: str) -> None:
            with self._ingest_lock:
                self.ingest_stats[name] += 1

        def patcher(key, arr):
            fld, vw, row, shards_t, gens, slots = parse(key)
            t = touched[(fld, vw, row)]
            new_gens = tuple(t[s][1] if s in t else g
                             for s, g in zip(shards_t, gens))
            if key[0] == "row":
                try:
                    with telemetry.timed("ingest", "patch_dense_words",
                                         arr.device):
                        new_arr = patch_dense_words(
                            arr, *self._dense_patch_masks(shards_t, t))
                except Exception:
                    count("patchDroppedDense")
                    raise
                count("patchedDense")
                return ("row", iname, fld, vw, row, shards_t,
                        new_gens), new_arr
            if key[0] == "run":
                # a point write can split, merge or extend intervals: no
                # patch; drop it so its memory frees now, and the next
                # read re-encodes the row from its run containers
                count("patchDropped")
                return None
            view = index.field(fld).view(vw)
            max_card = max((view.fragment(s).row_cardinality(row)
                            for s in shards_t
                            if view.fragment(s) is not None), default=0)
            if self.hybrid.pad_slots(max(max_card, 1)) != slots:
                # the read path probes pad_slots(current cardinality): a
                # leaf in another bucket would never be hit
                count("patchDropped")
                count("patchDroppedSparse")
                return None
            na = max((len(e[2]) for e in t.values()), default=0)
            nr = max((len(e[3]) for e in t.values()), default=0)
            adds = np.full((arr.shape[0], max(na, 1)), hy.SPARSE_SENTINEL,
                           dtype=np.int32)
            rems = np.full((arr.shape[0], max(nr, 1)), hy.SPARSE_SENTINEL,
                           dtype=np.int32)
            for i, s in enumerate(shards_t):
                e = t.get(s)
                if e is None:
                    continue
                if e[2]:
                    adds[i, :len(e[2])] = sorted(e[2])
                if e[3]:
                    rems[i, :len(e[3])] = sorted(e[3])
            with telemetry.timed("ingest", "patch_sparse_rows", arr.device):
                new_arr = patch_sparse_rows(arr, adds, rems)
            count("patchedSparse")
            return ("sparse", iname, fld, vw, row, shards_t, slots,
                    new_gens), new_arr

        self.residency.patch_entries(matcher, patcher)

    @staticmethod
    def _dense_patch_masks(shards_t: tuple, t: dict) -> tuple:
        """(shard slots, words, set masks, clear masks) of a dense leaf
        over `shards_t`: the batch's net columns reduced to one uint32
        mask pair per (shard, word), so every coordinate appears once."""
        slot_parts, col_parts, set_parts = [], [], []
        for i, s in enumerate(shards_t):
            e = t.get(s)
            if e is None:
                continue
            for cols, is_set in ((e[2], True), (e[3], False)):
                if cols:
                    c = np.fromiter(cols, dtype=np.int64, count=len(cols))
                    slot_parts.append(np.full(c.size, i, dtype=np.int64))
                    col_parts.append(c)
                    set_parts.append(np.full(c.size, is_set))
        if not col_parts:
            empty = np.empty(0, dtype=np.int64)
            return empty, empty, empty.astype(np.uint32), \
                empty.astype(np.uint32)
        slot = np.concatenate(slot_parts)
        col = np.concatenate(col_parts)
        is_set = np.concatenate(set_parts)
        coord = slot * WORDS_PER_SHARD + (col >> 5)
        uniq, inv = np.unique(coord, return_inverse=True)
        bits = np.left_shift(np.uint32(1), (col & 31).astype(np.uint32))
        smask = np.zeros(uniq.size, dtype=np.uint32)
        cmask = np.zeros(uniq.size, dtype=np.uint32)
        np.bitwise_or.at(smask, inv[is_set], bits[is_set])
        np.bitwise_or.at(cmask, inv[~is_set], bits[~is_set])
        return (uniq // WORDS_PER_SHARD, uniq % WORDS_PER_SHARD, smask,
                cmask)

    def ingest_snapshot(self) -> dict:
        """The batcher's counters merged with the apply, WAL and patch
        counters (executor.py:3738, the JAX package's /debug/vars
        `ingest` block, not served by the port)."""
        out = self.ingest.snapshot()
        with self._ingest_lock:
            out.update(self.ingest_stats)
        out["enabled"] = ingest_env_enabled()
        out["maxBatch"] = self.ingest.max_batch
        return out

    # ------------------------------------------------------- the cluster

    def _get_pool(self, attr: str, size: int, name: str):
        pool = getattr(self, attr)
        if pool is not None:
            return pool
        with self._pool_lock:
            if getattr(self, attr) is None:
                if attr in ("_fanout_pool", "_batch_exec_pool") \
                        and qos.enabled():
                    # ordered by the submitter's priority class
                    setattr(self, attr, qos.PriorityPool(
                        size, thread_name_prefix=name))
                else:
                    setattr(self, attr, ThreadPoolExecutor(
                        max_workers=size, thread_name_prefix=name))
            return getattr(self, attr)

    @property
    def fanout_pool(self):
        """The long-lived pool of outbound node batches (:337-345)."""
        return self._get_pool("_fanout_pool", max(4, self.fanout_pool_size),
                              "pilosa-torch-fanout")

    @property
    def batch_exec_pool(self):
        """The entries of inbound /internal/query-batch envelopes: apart
        from the fan-out pool, so two coordinators fanning out to each
        other cannot wait on each other's pool slots (:347-355)."""
        return self._get_pool("_batch_exec_pool",
                              max(2, self.batch_exec_pool_size),
                              "pilosa-torch-qbatch")

    @property
    def hedge_pool(self):
        """Hedged reads race here, apart from the fan-out pool."""
        return self._get_pool("_hedge_pool", max(4, self.fanout_pool_size),
                              "pilosa-torch-hedge")

    def fanout_pool_stats(self) -> dict:
        """Fan-out pool occupancy, without creating the pool."""
        pool = self._fanout_pool
        if pool is None:
            return {"size": max(4, self.fanout_pool_size), "threads": 0,
                    "queued": 0}
        return {"size": pool._max_workers, "threads": len(pool._threads),
                "queued": pool._work_queue.qsize()}

    def hedge_snapshot(self) -> dict:
        with self._hedge_lock:
            return {"hedgesFired": self.hedges_fired,
                    "hedgesWon": self.hedges_won,
                    "hedgesCancelled": self.hedges_cancelled}

    def shutdown(self) -> None:
        """Stop the executor's pools (Server.close)."""
        with self._pool_lock:
            for attr in ("_fanout_pool", "_batch_exec_pool", "_hedge_pool"):
                pool = getattr(self, attr)
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)
                    setattr(self, attr, None)

    def ici_enabled(self) -> bool:
        return self.ici_mode != "off"

    def _ici_route(self, call: Call, index: Index,
                   qshards: list) -> tuple[str, str]:
        """(route, reason) of one distributed read (:2664-2694).
        slice_local runs the whole shard set here, with no envelope.
        "auto" serves it so where this node's runner has a mesh (a
        single-device runner is not a slice: "auto" crosses nodes there);
        "on" wherever this node holds a replica of every query shard."""
        if not self.ici_enabled():
            return self.ROUTE_FALLBACK, "disabled"
        if self._call_has_write(call):
            return self.ROUTE_FALLBACK, "write"
        if not qshards:
            return self.ROUTE_FALLBACK, "no shards"
        if self.ici_mode == "auto" and self.runner.mesh is None:
            return self.ROUTE_CROSS_SLICE, "no mesh"
        if not self._ici_co_resident(index, qshards):
            return self.ROUTE_CROSS_SLICE, "shards not co-resident"
        if self.read_fence:
            with self._fence_lock:
                fenced = any((index.name, s) in self.read_fence
                             for s in qshards)
            if fenced:
                # a fenced shard may be stale: the fan-out re-routes it
                return self.ROUTE_CROSS_SLICE, "read-fenced"
        return self.ROUTE_SLICE_LOCAL, "co-resident"

    # decisions the co-residency memo keeps
    ICI_MEMO_MAX = 512

    def _ici_topo_fingerprint(self) -> tuple:
        """Membership, replicas and the down and draining marks: any change
        of them empties the co-residency memo."""
        c = self.cluster
        return (tuple(n.id for n in c.nodes), c.replica_n,
                frozenset(c.down_ids), frozenset(c.draining_ids))

    def _ici_co_resident(self, index: Index, qshards: list) -> bool:
        """Whether this node holds a replica of every query shard, memoized
        per (index, shards) under one topology fingerprint. A new
        fingerprint records topology.change (observer ici-router), and a
        decision that differs from the last topology's for the same key
        records ici.route_flip (:2620-2660)."""
        fp = self._ici_topo_fingerprint()
        key = (index.name, tuple(qshards))
        topo_flipped = False
        with self._ici_lock:
            if fp != self._ici_topo_fp:
                topo_flipped = self._ici_topo_fp is not None
                self._ici_prev_memo = dict(self._ici_route_memo)
                self._ici_route_memo.clear()
                self._ici_topo_fp = fp
            hit = self._ici_route_memo.get(key)
            if hit is not None:
                self._ici_route_memo.move_to_end(key)
                return hit
        if topo_flipped:
            _events.record(self.journal, "topology.change",
                           observer="ici-router", nodes=len(fp[0]),
                           down=len(fp[2]), draining=len(fp[3]))
        local = self.cluster.local_id
        ok = all(self.cluster.owns_shard(local, index.name, s)
                 for s in qshards)
        prev = self._ici_prev_memo.get(key)
        if prev is not None and prev != ok:
            _events.record(
                self.journal, "ici.route_flip", index=index.name,
                shards=len(qshards),
                route=self.ROUTE_SLICE_LOCAL if ok else self.ROUTE_CROSS_SLICE)
        with self._ici_lock:
            if fp == self._ici_topo_fp:
                self._ici_route_memo[key] = ok
                while len(self._ici_route_memo) > self.ICI_MEMO_MAX:
                    self._ici_route_memo.popitem(last=False)
        return ok

    def _record_route(self, route: str, reason: str, call: Call,
                      n_shards: int) -> None:
        with self._ici_lock:
            if route == self.ROUTE_SLICE_LOCAL:
                self.ici_slice_local += 1
            elif route == self.ROUTE_CROSS_SLICE:
                self.ici_cross_slice += 1
            else:
                self.ici_fallback += 1
        prof = qprofile.current_profile.get()
        if prof is not None:
            prof.record_route({"route": route, "reason": reason,
                               "call": call.name, "shards": n_shards})

    def ici_snapshot(self) -> dict:
        """The route counters (/debug/vars iciServing, /metrics) and the
        mesh program cache's (JAX executor.py:2712-2724)."""
        with self._ici_lock:
            out = {"mode": self.ici_mode,
                   "sliceLocal": self.ici_slice_local,
                   "crossSlice": self.ici_cross_slice,
                   "fallback": self.ici_fallback}
        out["programCache"] = ici_program_cache_stats()
        return out

    def _execute_distributed(self, index: Index, call: Call, shards):
        """One call over the cluster (:2727-2758): Options unwrapped
        before the fan-out (its shards= and exclude flags apply around
        the inner call), writes to their replicas, reads routed."""
        if call.name == "Options":
            if len(call.children) != 1:
                raise ExecutionError(
                    "Options() takes exactly one query argument")
            if call.args.get("shards") is not None:
                shards = [int(s) for s in call.uint_slice_arg("shards")]
            result = self._execute_distributed(index, call.children[0],
                                               shards)
            if call.bool_arg("excludeColumns") and isinstance(result, Row):
                result.segments = {}
            if call.bool_arg("excludeRowAttrs") and isinstance(result, Row):
                result.attrs = {}
            return result
        if call.name in self.WRITE_CALLS:
            return self._execute_write_distributed(index, call, shards)
        qshards = self._query_shards(index, shards)
        route, reason = self._ici_route(call, index, qshards)
        self._record_route(route, reason, call, len(qshards))
        if route == self.ROUTE_SLICE_LOCAL:
            return self._local_call(index, call, qshards)
        return self._execute_cross_slice(index, call, shards, qshards)

    def _execute_cross_slice(self, index: Index, call: Call, shards,
                             qshards: list):
        """Scatter and gather (:2760-2804): every other node's batch on
        the fan-out pool (in a copy of this context, so the trace id,
        deadline and profile follow), this node's inline, reduced as they
        land. GroupBy's limit is applied after the reduce."""
        fan_call = call
        if call.name == "GroupBy" and call.uint_arg("limit") is not None:
            fan_call = Call(call.name, {k: v for k, v in call.args.items()
                                        if k != "limit"}, call.children)
        groups = self._fanout_groups(index, qshards)
        if len(groups) <= 1:
            partials = []
            for node_id, node_shards in groups.items():
                partials.extend(self._map_node(index, fan_call, node_id,
                                               node_shards, set()))
            return self._reduce(call, partials, index, shards)
        local_shards = groups.pop(self.cluster.local_id, None)
        pool = self.fanout_pool
        futures = [threads.submit_ctx(pool, self._map_node, index, fan_call,
                                      node_id, node_shards, set())
                   for node_id, node_shards in groups.items()]
        partials = []
        if local_shards is not None:
            partials.extend(self._map_node(index, fan_call,
                                           self.cluster.local_id,
                                           local_shards, set()))
        for fut in futures:
            partials.extend(fut.result())
        return self._reduce(call, partials, index, shards)

    def _map_node(self, index: Index, call: Call, node_id: str,
                  node_shards: list, excluded: set) -> list:
        """`call` over node_shards on node_id; if the node fails, each of
        its shards is re-mapped onto its next replica (:2806-2860).
        Returns the partials."""
        qctx.check()
        prof = qprofile.current_profile.get()
        if node_id == self.cluster.local_id:
            t0 = time.perf_counter()
            out = [self._local_call(index, call, node_shards)]
            if prof is not None:
                prof.record_fanout(node_id, len(node_shards),
                                   (time.perf_counter() - t0) * 1e3,
                                   "local")
            return out
        node = self.cluster.node_by_id(node_id)
        err: Optional[Exception] = None
        if node is not None and node.uri:
            try:
                return [self._fanout_remote(index, call, node, node_shards,
                                            excluded)]
            except ClientError as e:
                err = e
        if prof is not None:
            prof.record_retry(node_id, len(node_shards),
                              str(err or "node unknown / no uri"))
        excluded = excluded | {node_id}
        regroup: dict[str, list] = {}
        for s in node_shards:
            replicas = [n.id for n in self.cluster.shard_nodes(index.name, s)
                        if n.id not in excluded]
            cand = next((r for r in replicas
                         if not self.cluster.is_unavailable(r)),
                        replicas[0] if replicas else None)
            if cand is None:
                raise ExecutionError(
                    f"shard {s} unavailable on all replicas: {err}")
            regroup.setdefault(cand, []).append(s)
        partials = []
        for cand, cand_shards in regroup.items():
            partials.extend(self._map_node(index, call, cand, cand_shards,
                                           excluded))
        return partials

    @classmethod
    def _call_has_write(cls, call: Call) -> bool:
        """A write anywhere in the tree: never coalesced, never hedged (a
        hedge re-sends)."""
        if call.name in cls.WRITE_CALLS:
            return True
        return any(cls._call_has_write(c) for c in call.children)

    def _fanout_remote(self, index: Index, call: Call, node,
                       node_shards: list, excluded: set):
        """One remote node batch, hedged when hedge_delay > 0 and a
        replica holds every shard of it."""
        if self.hedge_delay > 0 and not self._call_has_write(call):
            hedge_node = self._hedge_candidate(index, node, node_shards,
                                               excluded)
            if hedge_node is not None:
                return self._hedged_query(index, call, node, hedge_node,
                                          node_shards)
        return self._timed_node_query(index, call, node, node_shards)

    def _timed_node_query(self, index: Index, call: Call, node,
                          node_shards: list, hedge: bool = False):
        """The node RPC: a coalesced envelope entry when the coalescer is
        on and the call reads, per query otherwise. Its wall time goes to
        the fanoutLatency/<node> timing and the query's profile. The
        failpoint executor.fanout raises a ClientError, so an injected
        fault takes the failover a real peer failure takes."""
        failpoints.hit("executor.fanout", exc=ClientError)
        t0 = time.perf_counter()
        err = ""
        coalesced = (self.coalescer is not None
                     and not self._call_has_write(call))
        try:
            if coalesced:
                results = self.coalescer.query(
                    node.uri, index.name, call.to_pql(), shards=node_shards)
            else:
                results = self.client.query_proto(
                    node.uri, index.name, call.to_pql(),
                    shards=node_shards, remote=True)
        except BaseException as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.stats.timing(f"fanoutLatency/{node.id}", ms)
            prof = qprofile.current_profile.get()
            if prof is not None:
                prof.record_fanout(node.id, len(node_shards), ms,
                                   "coalesced" if coalesced else "proto",
                                   error=err, hedge=hedge)
        return results[0]

    def _hedge_candidate(self, index: Index, node, node_shards: list,
                         excluded: set):
        """The first live node (this one preferred) holding a replica of
        every shard of the batch, or None: hedging is batch-granular."""
        common: Optional[set] = None
        for s in node_shards:
            owners = {n.id for n in self.cluster.shard_nodes(index.name, s)}
            common = owners if common is None else common & owners
            if not common:
                return None
        common.discard(node.id)
        common -= set(excluded)
        common = {c for c in common if not self.cluster.is_unavailable(c)}
        if not common:
            return None
        if self.cluster.local_id in common:
            return self.cluster.node_by_id(self.cluster.local_id)
        return next((n for n in self.cluster.nodes if n.id in common), None)

    def _hedged_query(self, index: Index, call: Call, node, hedge_node,
                      node_shards: list):
        """A read's node batch, re-issued to hedge_node when the primary
        has not answered within hedge_delay of starting; the first answer
        wins and the other is cancelled or dropped, so a winner counts
        once. Both failing raises the primary's error into the per-shard
        failover (:2954-3032)."""
        pool = self.hedge_pool
        started = threading.Event()

        def primary_rpc():
            started.set()
            return self._timed_node_query(index, call, node, node_shards)

        primary = threads.submit_ctx(pool, primary_rpc)
        # the clock starts when the RPC starts, not when it was queued
        started.wait()
        done, _ = futures_wait([primary], timeout=self.hedge_delay)
        if done:
            return primary.result()
        with self._hedge_lock:
            self.hedges_fired += 1
        if hedge_node.id == self.cluster.local_id:
            def local_backup():
                t0 = time.perf_counter()
                out = self._local_call(index, call, node_shards)
                prof = qprofile.current_profile.get()
                if prof is not None:
                    prof.record_fanout(hedge_node.id, len(node_shards),
                                       (time.perf_counter() - t0) * 1e3,
                                       "local", hedge=True)
                return out

            backup = threads.submit_ctx(pool, local_backup)
        else:
            backup = threads.submit_ctx(pool, self._timed_node_query, index,
                                        call, hedge_node, node_shards, True)
        done, pending = futures_wait([primary, backup],
                                     return_when=FIRST_COMPLETED)
        winner = next((f for f in done if f.exception() is None), None)
        if winner is None and pending:
            done2, _ = futures_wait(pending)
            winner = next((f for f in done2 if f.exception() is None), None)
        if winner is None:
            raise primary.exception()
        loser = backup if winner is primary else primary
        with self._hedge_lock:
            if winner is backup:
                self.hedges_won += 1
            if not loser.done():
                loser.cancel()
                self.hedges_cancelled += 1
        prof = qprofile.current_profile.get()
        if prof is not None:
            prof.record_hedge(node.id, hedge_node.id, won=winner is backup)
        return winner.result()

    def _remote_write(self, node, index: Index, pql: str, shards):
        """One replica's share of a write, per query (never coalesced):
        its results, or None when the replica answered "draining" or was
        marked down since the write was planned (the caller hints it
        instead, :3120-3130). Any other failure refuses the write."""
        try:
            return self.client.query_proto(node.uri, index.name, pql,
                                           shards=shards, remote=True)
        except ClientError as e:
            draining = e.shed_reason == "draining"
            if draining or self.cluster.is_unavailable(node.id):
                if draining:
                    self.cluster.mark_draining(node.id)
                return None
            raise ExecutionError(f"replica write failed: {e}")

    def _execute_write_distributed(self, index: Index, call: Call, shards):
        """Set, Clear and SetColumnAttrs on every replica of the column's
        shard, SetRowAttrs on every node, Store and ClearRow on every
        owner of the query's shards (:3034-3156), the remote replicas
        before this node. An unavailable replica is skipped and gets a
        hint; a replica that cannot be reached fails the write; nothing
        is acknowledged that did not land on every replica that is not
        marked down or draining."""
        pql = call.to_pql()
        local_id = self.cluster.local_id
        if call.name in ("Store", "ClearRow"):
            qshards = self._query_shards(index, shards)
            targets: dict[str, list] = {}
            hinted: dict[str, list] = {}  # skipped replica -> shards
            for s in qshards:
                owners = self.cluster.shard_nodes(index.name, s)
                live = [n for n in owners
                        if not self.cluster.is_unavailable(n.id)]
                if not live:
                    raise ExecutionError(
                        f"all replicas down for write to shard {s}")
                for n in owners:
                    (targets if n in live else hinted).setdefault(
                        n.id, []).append(s)
            partials = []
            acked: set = set()
            for node_id in sorted(targets, key=lambda i: i == local_id):
                if node_id == local_id:
                    partials.append(self._local_call(index, call,
                                                     targets[node_id]))
                else:
                    res = self._remote_write(self.cluster.node_by_id(
                        node_id), index, pql, targets[node_id])
                    if res is None:
                        hinted.setdefault(node_id, []).extend(
                            targets[node_id])
                        continue
                    partials.append(res[0])
                acked.update(targets[node_id])
            if set(qshards) - acked:
                raise ExecutionError("all replicas draining for write")
            for nid, hshards in hinted.items():
                self._hint_write(nid, index.name, pql, sorted(hshards))
            return any(bool(p) for p in partials)
        new_shard = False
        col = None
        if call.name in ("Set", "Clear", "SetColumnAttrs"):
            col = self._translate_col(index, call.args.get("_col"),
                                      create=call.name != "Clear")
            if col is None:
                return False  # a Clear of an unknown key clears nothing
            targets = self.cluster.shard_nodes(index.name, col // SHARD_WIDTH)
            if call.name == "Set":
                fld = index.field(call.field_arg())
                new_shard = (fld is not None and not
                             fld.available_shards.contains(col // SHARD_WIDTH))
        else:  # SetRowAttrs
            targets = self.cluster.nodes
        live = [n for n in targets if not self.cluster.is_unavailable(n.id)]
        if targets and not live:
            raise ExecutionError("all replicas down for write")
        skipped = [n for n in targets if n not in live]
        result = None
        acked = 0
        # the remote replicas first: one that refuses fails the write
        # before this node applies it
        for node in sorted(live, key=lambda n: n.id == local_id):
            if node.id == local_id:
                r = self._local_call(index, call, None)
            else:
                res = self._remote_write(node, index, pql, None)
                if res is None:
                    skipped.append(node)
                    continue
                r = res[0]
            acked += 1
            result = r if result is None else (result or r)
        if targets and not acked:
            raise ExecutionError("all replicas draining for write")
        for node in skipped:
            self._hint_write(node.id, index.name, pql, None)
        if new_shard and self.announce_shard_fn is not None:
            # announced before the ack: a read through any node right
            # after it plans over the new shard
            self.announce_shard_fn(index.name, call.field_arg(),
                                   col // SHARD_WIDTH)
        if (call.name == "Set"
                and all(n.id != local_id for n in live)):
            # the shard exists on its (remote) replicas now; a local
            # replica's own write does the announcing add instead
            f = index.field(call.field_arg())
            if f is not None:
                f.add_available_shards([col // SHARD_WIDTH], quiet=True)
        return result

    def _hint_write(self, node_id: str, index_name: str, pql: str,
                    hshards) -> None:
        """A write skipped on an unavailable replica, kept as a durable
        hint for its return (:3158-3166); without a HintStore nothing is
        kept and anti-entropy heals the replica."""
        if self.hints is not None:
            self.hints.append(node_id, index_name, pql, shards=hshards)

    def _execute_ingest_remote(self, index: Index,
                               query: Query) -> Optional[list]:
        """A coordinator's replica envelope (remote=True, many Set/Clear
        calls): applied here directly, not queued again behind this
        node's own batcher (:3266-3281)."""
        prepared = self._ingest_prepare(index, query)
        if prepared is None:
            return None
        slots, muts = prepared
        if not muts:
            return list(slots)
        return self._ingest_unpack(slots, self._apply_fenced(index, muts))

    def _apply_ingest_distributed(self, index: Index, muts: list) -> list:
        """One coalesced batch over the cluster (:3303-3427): every other
        live replica of a mutation's shard is sent one multi-call
        remote=true envelope, then this node applies its share of the
        mutations no replica refused; a mutation is acknowledged only when
        every replica of its shard that is not marked down took it (the
        JAX package applies locally first, so a refused mutation can stay
        on this node there). An unavailable replica, or one that answers
        "draining", gets one hint per batch with the mutations that were
        acknowledged. Shards a batch created are announced to every node
        before the waiters wake."""
        n = len(muts)
        outcomes: list = [None] * n
        acked = [0] * n
        ored = [False] * n
        skipped = [False] * n
        local: list = []
        by_node: dict[str, list] = {}
        hint_by_node: dict[str, list] = {}
        new_shard_muts: list = []
        for mi, m in enumerate(muts):
            shard = m.shard
            targets = self.cluster.shard_nodes(index.name, shard)
            live = [t for t in targets
                    if not self.cluster.is_unavailable(t.id)]
            if targets and not live:
                outcomes[mi] = ("err", ExecutionError(
                    "all replicas down for write"))
                continue
            if m.is_set:
                fld = index.field(m.field_name)
                if (fld is not None
                        and not fld.available_shards.contains(shard)):
                    new_shard_muts.append((m.field_name, shard, mi))
            for t in targets:
                if t not in live:
                    skipped[mi] = True
                    hint_by_node.setdefault(t.id, []).append((mi, m))
                elif t.id == self.cluster.local_id:
                    local.append((mi, m))
                else:
                    by_node.setdefault(t.id, []).append((mi, m))
        # the remote replicas first, so a mutation a replica refused is
        # not applied here
        for node_id, items in by_node.items():
            node = self.cluster.node_by_id(node_id)
            pql = "\n".join(m.call.to_pql() for _, m in items)
            try:
                results = self._remote_write(node, index, pql, None)
            except ExecutionError as e:
                for mi, _m in items:
                    if outcomes[mi] is None:
                        outcomes[mi] = ("err", e)
                continue
            if results is None:  # demoted to a hint
                for mi, _m in items:
                    skipped[mi] = True
                hint_by_node.setdefault(node_id, []).extend(items)
                continue
            with self._ingest_lock:
                self.ingest_stats["remoteBatches"] += 1
                self.ingest_stats["remoteMutations"] += len(items)
            for (mi, _m), r in zip(items, results):
                acked[mi] += 1
                ored[mi] = ored[mi] or bool(r)
        local = [(mi, m) for mi, m in local if outcomes[mi] is None]
        if local:
            res = self._apply_fenced(index, [m for _, m in local])
            for (mi, _m), out in zip(local, res):
                if out[0] == "err":
                    outcomes[mi] = out
                else:
                    acked[mi] += 1
                    ored[mi] = ored[mi] or bool(out[1])
        for mi in range(n):
            if outcomes[mi] is not None:
                continue
            if skipped[mi] and not acked[mi]:
                outcomes[mi] = ("err", ExecutionError(
                    "all replicas draining for write"))
            else:
                outcomes[mi] = ("ok", ored[mi])
        # one hint per skipped replica per batch, of the acknowledged
        # mutations only (a refused one must not come back on replay)
        for node_id, items in hint_by_node.items():
            good = [m for mi, m in items if outcomes[mi][0] == "ok"]
            if not good:
                continue
            self._hint_write(node_id, index.name,
                             "\n".join(m.call.to_pql() for m in good), None)
            with self._ingest_lock:
                self.ingest_stats["hintedMutations"] += len(good)
        seen: set = set()
        for fname, shard, mi in new_shard_muts:
            if outcomes[mi][0] != "ok" or (fname, shard) in seen:
                continue
            seen.add((fname, shard))
            with self._ingest_lock:
                self.ingest_stats["newShards"] += 1
            if self.announce_shard_fn is not None:
                self.announce_shard_fn(index.name, fname, shard)
            if not self.cluster.owns_shard(self.cluster.local_id,
                                           index.name, shard):
                fld = index.field(fname)
                if fld is not None:
                    fld.add_available_shards([shard], quiet=True)
        n_err = sum(1 for o in outcomes if o[0] == "err")
        if n_err:
            with self._ingest_lock:
                self.ingest_stats["errors"] += n_err
        return outcomes

    def _reduce(self, call: Call, partials: list,
                index: Optional[Index] = None, shards=None):
        """The associative reduce (:3751-3806): counts summed as Python
        ints (a remote count arrives as a uint64), Sum summed, Min/Max by
        value with the counts of ties added, TopN merged then recounted
        exactly, Rows and GroupBy merged then limited, Row results merged
        shard by shard."""
        if not partials:
            raise ExecutionError("no shards to execute")
        if call.name == "Count":
            return sum(int(p) for p in partials)
        if call.name == "Sum":
            return ValCount(sum(int(p.val) for p in partials),
                            sum(int(p.count) for p in partials))
        if call.name in ("Min", "Max"):
            best = None
            for p in partials:
                if p.count == 0:
                    continue
                if best is None:
                    best = ValCount(p.val, p.count)
                elif p.val == best.val:
                    best.count += p.count
                elif (call.name == "Min") == (p.val < best.val):
                    best = ValCount(p.val, p.count)
            return best or ValCount(0, 0)
        if call.name == "TopN":
            merged = merge_pairs(partials)
            n = call.uint_arg("n") or None
            if (n is not None and call.uint_slice_arg("ids") is None
                    and index is not None):
                # phase 2: the winners recounted exactly on every owner
                return self._recount_topn(index, call,
                                          [i for i, _ in merged[:n]], shards)
            return Pairs(merged)
        if call.name == "Rows":
            out = sorted(set().union(*[set(p) for p in partials]))
            limit = call.uint_arg("limit")
            return RowIdentifiers(out[:limit] if limit is not None else out)
        if call.name == "GroupBy":
            acc: dict[str, dict] = {}
            for p in partials:
                for g in p:
                    key = str(g["group"])
                    if key in acc:
                        acc[key]["count"] += g["count"]
                    else:
                        acc[key] = dict(g)
            out = sorted(acc.values(), key=lambda g: [
                (x["field"], x["rowID"]) for x in g["group"]])
            limit = call.uint_arg("limit")
            return GroupCounts(out[:limit] if limit is not None else out)
        if call.name in BITMAP_CALLS:
            out = partials[0]
            for p in partials[1:]:
                out = out.merge(p)
            return out
        return partials[0]

    def _recount_topn(self, index: Index, call: Call, ids: list, shards):
        """TopN's phase 2 (:3808-3822): the merged winners recounted with
        ids= (n removed) on every owner of the query's shards."""
        recount = Call("TopN", {**call.args, "ids": ids}, call.children)
        recount.args.pop("n", None)
        partials = []
        groups = self._fanout_groups(index, self._query_shards(index, shards))
        for node_id, node_shards in groups.items():
            partials.extend(self._map_node(index, recount, node_id,
                                           node_shards, set()))
        merged = merge_pairs(partials)
        n = call.uint_arg("n")
        return Pairs(merged[:n] if n is not None else merged)

    # --------------------------------------------------------------- EXPLAIN

    def explain_call(self, index: Index, call: Call, shards) -> dict:
        """?explain=true (executor.py:958-1186): the planned tree with each
        leaf's form, sizing statistics, kernel family, residency state and
        estimated host-to-device bytes, without a launch, an upload or a
        change to the hysteresis (choose_representation peeks); the
        residency is probed without a hit, a miss or an LRU touch. The
        planner's counters move, as in the JAX package. The walk follows
        _compile's leaf discovery, so executing the query next makes the
        same choices."""
        shards = self._query_shards(index, shards)
        shards_t = tuple(shards)
        info = None
        planned = call
        if self.planner is not None and call.name in planner.PLANNED_CALLS:
            planned, info = self.planner.plan_call(index, call, shards)
        leaf_reps: list[str] = []
        kinds = self._LEAF_KIND_REP
        plane_bytes = len(shards) * WORDS_PER_SHARD * 4

        def probe_residency(field_name: str, row_id: int,
                            gens: tuple) -> dict:
            def match(key: tuple, need_gens: bool) -> bool:
                return (isinstance(key, tuple) and len(key) >= 7
                        and key[0] in kinds and key[1] == index.name
                        and key[2] == field_name
                        and key[3] == VIEW_STANDARD and key[4] == row_id
                        and key[5] == shards_t
                        and (not need_gens or key[-1] == gens))

            for need_gens in (True, False):
                hit = self.residency.probe_where(
                    lambda k: match(k, need_gens))
                if hit is not None:
                    # without the generations: a write landed since the
                    # upload; the entry is never hit again and ages out
                    return {"resident": True, "rep": kinds[hit[0][0]],
                            "generationMatch": need_gens, "bytes": hit[1]}
            return {"resident": False, "rep": None,
                    "generationMatch": False}

        def est_bytes(rep: str, slots: int) -> int:
            if rep == "sparse":
                return len(shards) * slots * 4
            if rep == "run":
                return len(shards) * 2 * slots * 4
            return plane_bytes

        def explain_row(field_name: str, row_id: int, c: Optional[Call],
                        expr: str) -> dict:
            stats: dict = {}
            rep, slots, _frags, gens = planner.choose_representation(
                self.hybrid, index, field_name, VIEW_STANDARD, shards,
                row_id, call=c, peek=True, stats_out=stats)
            leaf_reps.append(rep)
            res = probe_residency(field_name, row_id, gens)
            return {
                "kind": "row", "expr": expr, "field": field_name,
                "rowId": row_id, "rep": rep, "slots": slots,
                "maxShardCardinality": stats.get("maxShardCardinality"),
                "runIntervals": stats.get("runIntervals"),
                "residency": res,
                "estimatedH2dBytes":
                    0 if res["resident"] and res["generationMatch"]
                    else est_bytes(rep, slots),
            }

        def empty_leaf(kind: str, c: Call, field_name: str) -> dict:
            """An unknown key's leaf (executor.py:1026-1040): the empty
            row, nothing resident, nothing to upload."""
            leaf_reps.append("dense")
            return {"kind": kind,
                    "expr": qprofile.truncate_pql(c.to_pql(), 96),
                    "field": field_name, "rowId": None, "empty": True,
                    "rep": "dense",
                    "residency": {"resident": False, "rep": None,
                                  "generationMatch": False},
                    "estimatedH2dBytes": 0}

        def row_leaf(c: Call) -> dict:
            f, row_id = self._read_row_id(index, c)
            if row_id is None:
                return empty_leaf("row", c, f.name)
            return explain_row(f.name, row_id, c,
                               qprofile.truncate_pql(c.to_pql(), 96))

        def range_leaf(c: Call) -> dict:
            if "_start" in c.args or "_end" in c.args:
                f, row_id, views = self._time_range(index, c)
                if row_id is None:
                    return empty_leaf("timerange", c, f.name)
                leaf_reps.append("dense")
                gens = tuple(self._leaf_gens(index, f.name, v, shards,
                                             row_id) for v in views)
                nbytes = self.residency.probe(
                    ("timerange", index.name, f.name, row_id, views,
                     shards_t, gens))
                return {"kind": "timerange",
                        "expr": qprofile.truncate_pql(c.to_pql(), 96),
                        "field": f.name, "rowId": row_id,
                        "views": len(views), "rep": "dense",
                        "kernelFamily": "bitwise",
                        "residency": {"resident": nbytes is not None,
                                      "rep": "dense"
                                      if nbytes is not None else None,
                                      "generationMatch": nbytes is not None},
                        "estimatedH2dBytes":
                            0 if nbytes is not None else plane_bytes}
            cond_field, cond = None, None
            for k, v in c.args.items():
                if isinstance(v, Condition):
                    cond_field, cond = k, v
            if cond is None:
                raise ExecutionError(
                    "Range() requires a condition or time bounds")
            f = self._bsi_field(index, cond_field)
            depth = f.bit_depth
            leaf_reps.append("dense")
            val = (tuple(cond.value) if isinstance(cond.value, list)
                   else cond.value)
            nbytes = self.residency.probe(
                ("bsicmp", index.name, cond_field, cond.op, val, depth,
                 shards_t, self._bsi_state(index, f, shards)[1]))
            return {"kind": "bsicmp",
                    "expr": qprofile.truncate_pql(c.to_pql(), 96),
                    "field": cond_field, "op": cond.op, "bitDepth": depth,
                    "rep": "dense", "kernelFamily": "bsi",
                    "composedOnDevice": True,
                    "residency": {"resident": nbytes is not None,
                                  "rep": "dense"
                                  if nbytes is not None else None,
                                  "generationMatch": nbytes is not None},
                    # a miss composes the mask from the planes: depth + 1
                    # plane uploads when those are cold too (a bound)
                    "estimatedH2dBytes":
                        0 if nbytes is not None
                        else (depth + 1) * plane_bytes}

        def existence_leaf() -> dict:
            if index.existence_field() is None:
                raise ExecutionError(f"index {index.name} does not "
                                     "support existence tracking")
            return explain_row(EXISTENCE_FIELD_NAME, 0, None,
                               f"Not() existence ({EXISTENCE_FIELD_NAME})")

        def walk(c: Call) -> dict:
            if c.name == "Row":
                return row_leaf(c)
            if c.name == "Range":
                return range_leaf(c)
            if c.name in ("Union", "Xor", "Intersect", "Difference"):
                return {"kind": "op", "op": c.name,
                        "children": [walk(ch) for ch in c.children]}
            if c.name == "Not":
                if len(c.children) != 1:
                    raise ExecutionError("Not() takes exactly one argument")
                return {"kind": "op", "op": "Not",
                        "children": [existence_leaf(),
                                     walk(c.children[0])]}
            raise ExecutionError(f"expected bitmap call, got {c.name}")

        doc: dict = {"call": call.name, "shards": len(shards),
                     "planned": info is not None}
        if info is not None:
            doc["plan"] = info
        if planned.name in BITMAP_CALLS:
            doc["tree"] = walk(planned)
        else:
            operands = [walk(ch) for ch in planned.children
                        if ch.name in BITMAP_CALLS]
            if operands:
                doc["tree"] = (operands[0] if len(operands) == 1
                               else {"kind": "op", "op": "operands",
                                     "children": operands})
        if "tree" not in doc:
            return doc
        # the kernel family of each row leaf, decided over the whole
        # tree: an all-dense program runs as one program, a hybrid one
        # through the sparse and run families
        all_dense = all(r == "dense" for r in leaf_reps)
        fam_of = {"dense": "program" if all_dense else "bitwise",
                  "sparse": "sparse", "run": "run"}
        est = 0

        def finish(node: dict) -> None:
            nonlocal est
            if node.get("kind") == "op":
                for ch in node.get("children", ()):
                    finish(ch)
                return
            if "kernelFamily" not in node and "rep" in node:
                node["kernelFamily"] = fam_of.get(node["rep"], "bitwise")
            est += int(node.get("estimatedH2dBytes") or 0)

        finish(doc["tree"])
        doc["estimatedH2dBytes"] = est
        return doc

    # -------------------------------------------------------------- HBM map

    _LEAF_KIND_REP = {"row": "dense", "sparse": "sparse", "run": "run"}

    def _leaf_waste(self, key: tuple, nbytes: int) -> int:
        """Padding of one resident row leaf: bytes beyond what its
        cardinality (sparse) or interval count (run) needs; a dense plane
        on one device has none (executor.py:850-876)."""
        kind, shards = key[0], key[5]
        if kind == "row":
            return max(0, nbytes - len(shards) * WORDS_PER_SHARD * 4)
        index = self.holder.index(key[1])
        f = index.field(key[2]) if index is not None else None
        view = f.view(key[3]) if f is not None else None
        useful = 0
        if view is not None:
            slots = key[6]
            for s in shards:
                frag = view.fragment(s)
                if frag is None:
                    continue
                if kind == "sparse":
                    useful += min(frag.row_cardinality(key[4]), slots) * 4
                else:  # run: [start, last] int32 pairs
                    useful += min(frag.row_interval_count(key[4]),
                                  slots) * 8
        return max(0, nbytes - useful)

    def hbm_snapshot(self, top: int = 64) -> dict:
        """GET /debug/hbm (executor.py:877): resident row leaves by
        (index, field, form) with bytes and padding, other kinds by kind,
        the budget and headroom, joined with the CUDA caching allocator
        (allocated and reserved bytes). planCacheBytes and
        planCacheEntries are the plan cache's, as the JAX package counts
        them (a scalar at its nominal 256 bytes). accountedBytes is the
        device memory the resident leaves and the cached tensors hold,
        each storage once: entries may alias one tensor (a Range mask that
        is the not-null row, a cached Row result that is the resident
        leaf), and residentBytes and planCacheBytes count every entry, as
        the budgets do; the JAX package sums those two instead.
        hbmDriftBytes is allocated minus accounted: memory neither cache
        holds (query intermediates, the batchers' outputs, leaks)."""
        by_field: dict = {}
        other: dict = {}
        storages: dict = {}
        waste_by_rep = {"dense": 0, "sparse": 0, "run": 0}
        for key, nbytes, held in self.residency.entries_snapshot():
            storages.update(held)
            kind = key[0] if isinstance(key, tuple) and key else "?"
            rep = self._LEAF_KIND_REP.get(kind)
            if rep is not None and len(key) >= 6:
                g = by_field.setdefault(
                    (key[1], key[2], rep),
                    {"leaves": 0, "bytes": 0, "wasteBytes": 0})
                g["leaves"] += 1
                g["bytes"] += nbytes
                w = self._leaf_waste(key, nbytes)
                g["wasteBytes"] += w
                waste_by_rep[rep] += w
            else:
                o = other.setdefault(str(kind), {"entries": 0, "bytes": 0})
                o["entries"] += 1
                o["bytes"] += nbytes
        fields = [{"index": idx, "field": fld, "rep": rep, **g}
                  for (idx, fld, rep), g in by_field.items()]
        fields.sort(key=lambda e: (-e["bytes"], e["index"], e["field"],
                                   e["rep"]))
        res = self.residency.snapshot()
        pc = {"bytes": 0, "entries": 0}
        if self.plan_cache is not None:
            pc = self.plan_cache.snapshot()
            storages.update(self.plan_cache.storages())
        accounted = sum(storages.values())
        alloc = None
        dev = self.runner.device
        for d in telemetry.device_memory_stats():
            if dev.type == "cuda" and d["device"] == f"cuda:{dev.index}":
                ms = d["memoryStats"]
                alloc = {"bytesInUse": ms["bytes_in_use"],
                         "bytesReserved": ms["bytes_reserved"],
                         "bytesLimit": ms["bytes_limit"], "devices": 1}
        return {
            "budgetBytes": self.residency.budget,
            "residentBytes": res["bytes"],
            "headroomBytes": max(0, self.residency.budget - res["bytes"]),
            "entries": res["entries"],
            "evictions": res["evictions"],
            "planCacheBytes": pc["bytes"],
            "planCacheEntries": pc["entries"],
            "accountedBytes": accounted,
            "allocator": alloc,
            "hbmDriftBytes": (alloc["bytesInUse"] - accounted)
            if alloc is not None else None,
            "wasteByRep": waste_by_rep,
            "byField": fields[:max(0, int(top))] if top else fields,
            "byFieldTruncated": bool(top) and len(fields) > int(top),
            "otherKinds": other,
        }
