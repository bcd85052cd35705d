"""Device residency: an LRU cache of query leaves on the device, and the
hybrid representation chooser.

Trimmed port of pilosa_tpu/parallel/residency.py DeviceResidency: each
leaf (one row over a shard set in its dense, sparse or run form, a BSI
plane slab, a Range mask) stays resident keyed by its content
generations, so repeat queries run without host->device transfers and a
write changes the key; after an ingest batch, patch_entries (:169-212)
moves the written rows' leaves to their new keys with the batch applied.
Eviction is LRU by byte budget; a leaf costs its tensor.nbytes. With
`eviction = "heat"` (:128-170) the victim is the occupant whose fragments
are coldest by the heat map (utils/heat.py), LRU order breaking ties;
any kill switch forces LRU. A leaf read records a hit or a miss with its
upload bytes on the query's profile (:72), and uploads and evictions
charge the heat map; a real upload charges its bytes to the request's
usage account as hbm_bytes (:95-99), and a plan-cache hit charges
plan_cache_hits (:568-574), outside the LRU lock. Lock order: the residency lock, then the heat
tracker's, never the reverse.

The default budget is half of the card's memory
(torch.cuda.get_device_properties(0).total_memory // 2), leaving the rest
to query intermediates and the batcher's outputs. On the CPU (tests) it is
a fixed 1 GiB. A leaf costs its nbytes, one copy of its logical (padded)
shape, as a sharded jax.Array's nbytes counts it; on a mesh every replica
row holds a copy, so the executor scales the budget by its runner's
budget_scale (shard slots over the most positions one device holds: half
on a 2 x 4 mesh on one card), and a device's own share stays within the
half.

HybridManager (:290-520) picks each row leaf's form: sparse index array,
run intervals or dense plane. PlanCache (:520-609) holds evaluated bitmap
subtrees and Count scalars under the planner's generation keys.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from pilosa_tpu_torch.parallel.blocks import Blocked
from pilosa_tpu_torch.utils import accounting
from pilosa_tpu_torch.utils import heat as _heat
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import telemetry

BUDGET_FRACTION = 0.5
CPU_BUDGET_BYTES = 1 << 30


def default_budget(device: torch.device) -> int:
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return int(total * BUDGET_FRACTION)
    return CPU_BUDGET_BYTES


class DeviceResidency:
    def __init__(self, runner):
        self.runner = runner
        self.budget = default_budget(runner.device)
        self._lru: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.epoch = 0  # bumped by clear(); fences in-flight misses
        # the heat map (set by the Executor; None: untracked) and the
        # [storage] eviction policy, lru or heat
        self.heat = None
        self.eviction = "lru"
        self.heat_evictions = 0  # victims chosen by heat, not LRU order

    def leaf(self, key: tuple,
             make: Callable[[], "np.ndarray | torch.Tensor"],
             put: Optional[Callable] = None) -> torch.Tensor:
        """The device tensor for `key`. On a miss make() gives a host array,
        uploaded by `put` (default runner.put_leaf), or a tensor already on
        the device (a BSI slab, a Range mask), cached as it is; only the
        former counts as an upload, as in the JAX package. `key` must
        encode content generations."""
        prof = qprofile.current_profile.get()
        with self._lock:
            arr = self._lru.get(key)
            if arr is not None:
                self._lru.move_to_end(key)
                self.hits += 1
            epoch = self.epoch
        if arr is not None:
            if prof is not None:
                prof.record_residency(hit=True)
            return arr
        # built and uploaded outside the lock: concurrent misses of other
        # keys must not serialize behind one host->device transfer
        host = make()
        uploaded = not isinstance(host, (torch.Tensor, Blocked))
        arr = (put or self.runner.put_leaf)(host) if uploaded else host
        if prof is not None:
            prof.record_residency(hit=False,
                                  nbytes=arr.nbytes if uploaded else 0)
        if uploaded:
            acct = accounting.current_account.get()
            if acct is not None:
                acct.charge(hbm_bytes=arr.nbytes)
        tracker = self.heat
        if uploaded and tracker is not None and tracker.enabled:
            for fr in _heat.leaf_frags(key):
                tracker.touch_many(fr, h2d_bytes=arr.nbytes, uploads=1)
        with self._lock:
            self.misses += 1
            if self.epoch != epoch:
                # clear() ran meanwhile (index/field deleted): serve, but
                # never cache what may describe deleted schema
                return arr
            displaced = self._lru.pop(key, None)
            if displaced is not None:
                self.bytes -= displaced.nbytes
            self._lru[key] = arr
            self.bytes += arr.nbytes
            self._evict_locked(key)
        return arr

    def _evict_locked(self, protect: tuple) -> None:
        """Evict until under budget, never `protect` (the entry just
        inserted): the least recently used entry, or with eviction "heat"
        the one whose fragments' summed scores are lowest (the first in
        LRU order on a tie). Heat eviction needs a tracker that is on and
        the env switch on; any of them off means LRU. Called with
        self._lock held."""
        tracker = self.heat
        by_heat = (self.eviction == "heat" and tracker is not None
                   and tracker.enabled and _heat.enabled())
        while self.bytes > self.budget and len(self._lru) > 1:
            victim_key = None
            if by_heat:
                best = None
                now = time.monotonic()  # one clock for the whole ranking
                for k in self._lru:
                    if k == protect:
                        continue
                    s = sum(x for fr in _heat.leaf_frags(k)
                            for x in tracker.scores_for(fr, now).tolist())
                    if best is None or s < best:
                        victim_key, best = k, s
            if victim_key is not None:
                old = self._lru.pop(victim_key)
                self.heat_evictions += 1
            else:
                victim_key, old = self._lru.popitem(last=False)
            self.bytes -= old.nbytes
            self.evictions += 1
            if tracker is not None and tracker.enabled:
                for fr in _heat.leaf_frags(victim_key):
                    tracker.touch_many(fr, evictions=1)

    def patch_entries(self, matcher: Callable[[tuple], bool],
                      patcher: Callable) -> tuple[int, int]:
        """Rewrite every resident entry whose key `matcher` selects: the
        ingest path's write-through (pilosa_tpu/parallel/residency.py:
        169-212). `patcher(key, tensor)` runs outside the lock and returns
        (new_key, new_tensor), the patched leaf under its post-write key,
        or None to drop the entry. Either way the old key goes: it carries
        pre-write generations and can never be hit again. A patcher that
        raises drops its entry (the next read re-uploads it). A clear()
        meanwhile (index or field deleted) stops the swaps, as it fences
        leaf(). Returns (patched, dropped)."""
        with self._lock:
            keys = [k for k in self._lru if matcher(k)]
            epoch = self.epoch
        patched = dropped = 0
        for k in keys:
            with self._lock:
                arr = self._lru.get(k)
            if arr is None:
                continue
            try:
                res = patcher(k, arr)
            except Exception:  # noqa: BLE001 — the next read re-uploads
                res = None
            with self._lock:
                if self.epoch != epoch:
                    break
                old = self._lru.pop(k, None)
                if old is None:
                    continue
                self.bytes -= old.nbytes
                if res is None:
                    dropped += 1
                    continue
                new_key, new_arr = res
                displaced = self._lru.pop(new_key, None)
                if displaced is not None:
                    self.bytes -= displaced.nbytes
                self._lru[new_key] = new_arr
                self.bytes += new_arr.nbytes
                patched += 1
                self._evict_locked(new_key)
        return patched, dropped

    def peek(self, key: tuple) -> Optional[torch.Tensor]:
        """The resident tensor for `key`, or None, without counting a hit
        or a miss (a representation probe is not a leaf read). Touches
        the LRU order: a probe that finds an entry is about to read it."""
        with self._lock:
            arr = self._lru.get(key)
            if arr is not None:
                self._lru.move_to_end(key)
            return arr

    def probe(self, key: tuple) -> Optional[int]:
        """Byte size of the entry under `key`, or None, with no hit or miss
        counted and no LRU touch: EXPLAIN observes the cache without
        changing its eviction order (:225-233)."""
        with self._lock:
            arr = self._lru.get(key)
            return None if arr is None else arr.nbytes

    def probe_where(self, pred: Callable[[tuple], bool]) -> Optional[tuple]:
        """(key, nbytes) of the first entry, in LRU order, whose key
        satisfies `pred`, or None; read-only like probe() (EXPLAIN's
        stale-generation probe, :235-245)."""
        with self._lock:
            for key, arr in self._lru.items():
                try:
                    if pred(key):
                        return key, arr.nbytes
                except Exception:  # noqa: BLE001 — a malformed key
                    continue
            return None

    def entries_snapshot(self) -> list[tuple]:
        """[(key, nbytes, storages)] of every resident entry (GET
        /debug/hbm): storages lists (data pointer, bytes) of the memory
        the tensor views, one per block of a blocked leaf, shared where
        entries alias one tensor (a Range mask that is the field's
        not-null row is cached under both keys)."""
        with self._lock:
            return [(key, arr.nbytes, held_storages(arr))
                    for key, arr in self._lru.items()]

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self.bytes = 0
            self.epoch += 1

    def drop_where(self, pred: Callable[[tuple], bool]) -> None:
        """Drop every entry whose key satisfies `pred` (a deleted field's
        leaves) and fence in-flight misses as clear() does."""
        with self._lock:
            for k in [k for k in self._lru if pred(k)]:
                self.bytes -= self._lru.pop(k).nbytes
            self.epoch += 1

    def snapshot(self) -> dict:
        """Counters, and entries and bytes per leaf kind (key[0]: "row",
        "sparse", "run", "bsiplanes", ...)."""
        with self._lock:
            by_kind: dict = {}
            for key, arr in self._lru.items():
                k = by_kind.setdefault(str(key[0]), {"entries": 0, "bytes": 0})
                k["entries"] += 1
                k["bytes"] += arr.nbytes
            return {"entries": len(self._lru), "bytes": self.bytes,
                    "budget": self.budget, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "heatEvictions": self.heat_evictions,
                    "eviction": self.eviction, "by_kind": by_kind}


# ---------------------------------------------------------------------------
# Hybrid sparse/run/dense representation choice
# ---------------------------------------------------------------------------

# rows with at most this many set bits in every shard upload as sorted
# index arrays (ops/hybrid.py), 0 disables: the roaring array/bitmap flip
# applied per shard (a 4096-slot row is 16 KiB against a 128 KiB plane)
DEFAULT_SPARSE_THRESHOLD = 4096

# rows above the sparse threshold upload as [start, last] interval pairs
# while their interval count is at most this, 0 disables (2048 pairs are
# 16 KiB against the plane)
DEFAULT_RUN_THRESHOLD = 2048

# smallest sparse allocation; slots bucket to powers of two
SPARSE_SLOT_MIN = 8

# byte weight of the three forms: toward heavier is a promotion
_REP_ORDER = {"sparse": 0, "run": 1, "dense": 2}

# rows whose last form is remembered (LRU), the hysteresis state
REP_MEMORY_BOUND = 1 << 16

# (row, shard set) leaves whose choice statistics are kept (LRU); a key
# holds its shard tuple and generations, 16 KiB at 1024 shards
STATS_MEMORY_BOUND = 1 << 12


def hybrid_env_enabled() -> bool:
    """PILOSA_TPU_TORCH_HYBRID=0 stops sparse and run uploads at the choice
    site, read on every call (the JAX package's PILOSA_TPU_HYBRID).
    Resident sparse and run leaves stay correct and age out by LRU."""
    return os.environ.get("PILOSA_TPU_TORCH_HYBRID", "1") != "0"


class HybridManager:
    """Per-row choice of sparse, run or dense leaves, with promote/demote
    hysteresis and heat-informed demotion. Port of pilosa_tpu/parallel/
    residency.py HybridManager (:324-520): inside a band, a heavier row
    keeps its form while any of its fragments is hot, and demotes when all
    are cold or its signal falls below the band floor. Without a tracker
    (PILOSA_TPU_TORCH_HEAT=0) a row is never cold. The choice never
    changes an answer: the three forms evaluate bit-identically
    (ops/hybrid.py)."""

    def __init__(self, threshold: int = DEFAULT_SPARSE_THRESHOLD,
                 hysteresis: float = 0.25, heat=None,
                 run_threshold: int = DEFAULT_RUN_THRESHOLD):
        self.threshold = int(threshold)
        self.run_threshold = int(run_threshold)
        # a heavier row keeps its form until its signal falls below
        # threshold * (1 - hysteresis), or its fragments go cold
        self.hysteresis = float(hysteresis)
        self.heat = heat  # utils/heat.py HeatTracker or None
        self._lock = threading.Lock()
        self._rep: "OrderedDict[tuple, str]" = OrderedDict()
        self._stats: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.sparse_uploads = 0
        self.run_uploads = 0
        self.dense_uploads = 0
        self.promoted = 0
        self.demoted = 0
        self.run_transitions = 0
        self.materialized = 0  # sparse/run leaves expanded to planes
        self.sparse_bytes_uploaded = 0
        self.run_bytes_uploaded = 0
        self.dense_bytes_uploaded = 0

    def active(self) -> bool:
        return self.threshold > 0 and hybrid_env_enabled()

    @staticmethod
    def pad_slots(cardinality: int) -> int:
        """Power-of-two slot count covering `cardinality`, at least 8."""
        k = SPARSE_SLOT_MIN
        while k < cardinality:
            k <<= 1
        return k

    def _cold(self, frags) -> bool:
        """True when every fragment of the row scores below HOT_SCORE.
        `frags` is a heat.Frags or a list of fragment keys; no tracker, or
        no fragments, is never cold."""
        tracker = self.heat
        if tracker is None or not tracker.enabled or frags is None:
            return False
        n = len(frags.shards) if isinstance(frags, _heat.Frags) \
            else len(frags)
        if not n:
            return False
        return max(tracker.scores_for(frags)) < _heat.HOT_SCORE

    def _transition(self, prev, max_card: int, frags=None,
                    run_stats=None) -> str:
        """Crossing a threshold upward promotes at once; inside a band a
        heavier row keeps its form while any of its fragments is hot, and
        demotes when they are all cold or below the band floor. run_stats
        is a sequence whose first item is the row's interval count (the
        JAX package passes (count, max run length); only the count
        decides), or None where the caller has none: then a run row stays
        run, anything else decides sparse or dense."""
        lo = self.threshold * (1.0 - self.hysteresis)
        if max_card > self.threshold:
            n_iv = None if run_stats is None else int(run_stats[0])
            if n_iv is None or self.run_threshold <= 0:
                return "run" if prev == "run" else "dense"
            run_lo = self.run_threshold * (1.0 - self.hysteresis)
            if n_iv > self.run_threshold:
                return "dense"
            if prev == "dense" and n_iv > run_lo:
                return "run" if self._cold(frags) else "dense"
            return "run"
        if prev in ("dense", "run") and max_card > lo:
            return "sparse" if self._cold(frags) else prev
        return "sparse"

    def _remember(self, row_key: tuple, prev, rep: str) -> None:
        with self._lock:
            if prev is not None and prev != rep:
                if _REP_ORDER[rep] > _REP_ORDER.get(prev, 0):
                    self.promoted += 1
                else:
                    self.demoted += 1
                if prev == "run" or rep == "run":
                    self.run_transitions += 1
            self._rep[row_key] = rep
            self._rep.move_to_end(row_key)
            while len(self._rep) > REP_MEMORY_BOUND:
                self._rep.popitem(last=False)

    def choose(self, row_key: tuple, max_card: int, frags=None,
               run_stats=None, peek: bool = False) -> tuple[str, int]:
        """(form, padded slots) of one row leaf whose largest per-shard
        cardinality is max_card: interval-pair slots for "run", index
        slots for "sparse", 0 for "dense". frags are the leaf's fragments
        (heat.Frags), read for the cold test. peek=True leaves the
        hysteresis memory as it is."""
        if not self.active():
            return "dense", 0
        with self._lock:
            prev = self._rep.get(row_key)
        rep = self._transition(prev, max_card, frags, run_stats)
        if not peek:
            self._remember(row_key, prev, rep)
        if rep == "run":
            n_iv = 1 if run_stats is None else int(run_stats[0])
            return rep, self.pad_slots(max(n_iv, 1))
        return rep, self.pad_slots(max(int(max_card), 1))

    def leaf_stats(self, leaf_key: tuple, gens: tuple) -> list:
        """[max cardinality, max interval count] last read for a (row,
        shard set) leaf under `gens`; a fresh [None, None] when the
        generations moved, for the caller to fill."""
        with self._lock:
            entry = self._stats.get(leaf_key)
            if entry is None or entry[0] != gens:
                entry = (gens, [None, None])
                self._stats[leaf_key] = entry
            self._stats.move_to_end(leaf_key)
            while len(self._stats) > STATS_MEMORY_BOUND:
                self._stats.popitem(last=False)
            return entry[1]

    def clear_stats(self) -> None:
        """Forget every leaf's statistics (index/field deletion: a
        recreated schema object restarts its generations)."""
        with self._lock:
            self._stats.clear()

    def drop_field(self, index: str, field: str) -> None:
        """Forget the forms and statistics of a deleted field's rows."""
        with self._lock:
            for d in (self._rep, self._stats):
                for k in [k for k in d if k[:2] == (index, field)]:
                    del d[k]

    def last(self, row_key: tuple) -> Optional[str]:
        """The form last chosen for the row (None if none is remembered)."""
        with self._lock:
            return self._rep.get(row_key)

    def observe(self, row_key: tuple, max_card: int, frags=None,
                run_stats=None) -> None:
        """Write-side hysteresis tick for a row with history, once per
        touched row and fragment per applied ingest batch (residency.py:
        458-474): the same transition rule as choose(); rows never chosen
        are left alone."""
        if not self.active():
            return
        with self._lock:
            prev = self._rep.get(row_key)
        if prev is None:
            return
        self._remember(row_key, prev, self._transition(prev, max_card,
                                                        frags, run_stats))

    def record_upload(self, rep: str, nbytes: int) -> None:
        with self._lock:
            if rep == "sparse":
                self.sparse_uploads += 1
                self.sparse_bytes_uploaded += int(nbytes)
            elif rep == "run":
                self.run_uploads += 1
                self.run_bytes_uploaded += int(nbytes)
            else:
                self.dense_uploads += 1
                self.dense_bytes_uploaded += int(nbytes)
        # h2d bytes per kernel family: the leaf uploads are the dominant
        # host->device traffic, charged to the family that reads the form
        if telemetry.kernel_stats_enabled():
            fam = {"sparse": "sparse", "run": "run"}.get(rep, "bitwise")
            telemetry.kernels.record_bytes(fam, h2d=int(nbytes))

    def record_materialize(self) -> None:
        with self._lock:
            self.materialized += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.active(),
                "threshold": self.threshold,
                "runThreshold": self.run_threshold,
                "hysteresis": self.hysteresis,
                "sparseUploads": self.sparse_uploads,
                "runUploads": self.run_uploads,
                "denseUploads": self.dense_uploads,
                "promoted": self.promoted,
                "demoted": self.demoted,
                "runTransitions": self.run_transitions,
                "materialized": self.materialized,
                "sparseBytesUploaded": self.sparse_bytes_uploaded,
                "runBytesUploaded": self.run_bytes_uploaded,
                "denseBytesUploaded": self.dense_bytes_uploaded,
                "trackedRows": len(self._rep),
            }


def tensor_storage(t: torch.Tensor) -> tuple:
    """(data pointer, bytes) of the memory a tensor views: entries that
    alias one tensor share it, so device memory is counted once."""
    st = t.untyped_storage()
    return st.data_ptr(), st.nbytes()


def held_storages(t) -> list:
    """tensor_storage of a tensor, or of each block of a blocked one (a
    mesh leaf: every position's copy is device memory)."""
    if isinstance(t, Blocked):
        return t.storages()
    return [tensor_storage(t)]


class PlanCache:
    """Generation-keyed cross-query result cache (:520-609).

    Where DeviceResidency holds query leaves, this holds evaluated
    subexpressions: the [S, W] device result of a bitmap call tree, or the
    int of a Count over one, under the planner's key (planner.
    subtree_cache_key: index, canonical PQL, shard set, per-leaf
    generations). A write changes the key; the stale entry ages out by
    LRU. A tensor is charged its nbytes, an int the nominal SCALAR_COST,
    so a flood of distinct Counts still evicts. A cached tensor may be a
    resident leaf itself (a Row(f=a) result, a Range mask): a write moves
    that leaf to a new key with a patched copy (DeviceResidency.
    patch_entries), and the old plan-cache key, which carries the old
    generations, is never computed again. `enabled` flips at run time
    without tearing down the executor."""

    SCALAR_COST = 256  # nominal bytes of a cached scalar

    DEFAULT_BUDGET_BYTES = 256 << 20

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES):
        self.budget = budget_bytes
        self.enabled = True
        self._lru: OrderedDict = OrderedDict()  # key -> (value, nbytes)
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.epoch = 0  # bumped by clear(); fences in-flight computes

    def get(self, key: tuple):
        """The cached value, or None (a miss; a zero count is cached as
        the int 0)."""
        if not self.enabled:
            return None
        with self._lock:
            entry = self._lru.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._lru.move_to_end(key)
            self.hits += 1
            value = entry[0]
        acct = accounting.current_account.get()
        if acct is not None:
            acct.charge(plan_cache_hits=1)
        return value

    def put(self, key: tuple, value, nbytes: int,
            epoch: Optional[int] = None) -> None:
        """Insert `value` (a device tensor or an int). `epoch` is the one
        the caller read before computing: a clear() since (index or field
        deleted) means the value may describe deleted schema, so it is
        served and not cached."""
        if not self.enabled:
            return
        with self._lock:
            if epoch is not None and epoch != self.epoch:
                return
            displaced = self._lru.pop(key, None)
            if displaced is not None:
                self.bytes -= displaced[1]
            self._lru[key] = (value, nbytes)
            self.bytes += nbytes
            while self.bytes > self.budget and len(self._lru) > 1:
                _, (_, old_bytes) = self._lru.popitem(last=False)
                self.bytes -= old_bytes
                self.evictions += 1

    def storages(self) -> list[tuple]:
        """(data pointer, bytes) of every cached tensor's memory; scalars
        hold none."""
        with self._lock:
            return [st for v, _ in self._lru.values()
                    if isinstance(v, (torch.Tensor, Blocked))
                    for st in held_storages(v)]

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self.bytes = 0
            self.epoch += 1

    def drop_where(self, pred: Callable[[tuple], bool]) -> None:
        """Drop every entry whose key satisfies `pred`, fencing in-flight
        computes as clear() does."""
        with self._lock:
            for k in [k for k in self._lru if pred(k)]:
                self.bytes -= self._lru.pop(k)[1]
            self.epoch += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._lru), "bytes": self.bytes,
                    "budget": self.budget, "enabled": self.enabled,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
