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
Min/Max through the greedy descents of ops/bsi.py. Totals finish exactly
on the host: value = sum of 2^i * count_i + min * count.

TopN (:1835-2164) picks candidates from the per-shard rank caches (merged
across shards, memoized on the caches' versions) and recounts them
exactly: from container metadata without a Src, through the
topn_counts_packed kernel with one (the threshold-pruned walk over
256-row blocks, the Tanimoto band, the ids= recount). Rows (:2168-2215)
reads row ids from the fragments. GroupBy (:2217-2423) stacks each Rows
axis into one resident [R, S, W] slab and counts every level past the
first with the cross_count_matrix kernel, pruned on the device, one host
fetch per level.

Not(x) is existence &~ x (executor.py:1317-1322).

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
would (int fields, other field types, timestamps, string keys, missing
fields) takes the per-bit path. Reads of an index wait while a batch is
applied to it and its leaves patched (ApplyFence, the port's own), so no
read builds a key whose generations are half before and half after a
batch.

Left out: the rest of the planner and the plan cache, heat, the cluster
(its distributed and remote ingest applies included), key translation,
row attributes and the MinMaxBatcher. None of them changes an answer.
Calls, field types and options outside the slice raise NotPortedError (a
400 at the API).
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from pilosa_tpu_torch import planner
from pilosa_tpu_torch.constants import (
    EXISTENCE_FIELD_NAME,
    SHARD_WIDTH,
    WORDS_PER_SHARD,
)
from pilosa_tpu_torch.device import planes_to_tensor
from pilosa_tpu_torch.models.cache import merge_pair_arrays, merge_pairs
from pilosa_tpu_torch.models.field import NotPortedError
from pilosa_tpu_torch.models.index import Index
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.ops import bsi
from pilosa_tpu_torch.ops import hybrid as hy
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitvector import (
    band,
    columns_from_dense,
    patch_dense_words,
    patch_sparse_rows,
)
from pilosa_tpu_torch.ops.topn import tanimoto_mask
from pilosa_tpu_torch.parallel.batcher import CountBatcher, PlaneSumBatcher
from pilosa_tpu_torch.parallel.ingest import (
    ApplyFence,
    IngestBatcher,
    Mutation,
    ingest_env_enabled,
)
from pilosa_tpu_torch.parallel.mesh import DeviceRunner
from pilosa_tpu_torch.parallel.residency import (
    DeviceResidency,
    HybridManager,
)
from pilosa_tpu_torch.pql import Call, Query, parse_string_cached
from pilosa_tpu_torch.pql.parser import parse_mutations_fast
from pilosa_tpu_torch.pql.ast import (
    BETWEEN,
    EQ,
    GT,
    GTE,
    LT,
    LTE,
    NEQ,
    Condition,
)

BITMAP_CALLS = {"Row", "Union", "Intersect", "Difference", "Xor", "Not",
                "Range"}
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
# static bound of a GroupBy chunk's pruned transfer; a chunk with more
# live groups refetches its whole count matrix
GROUPBY_LIVE_CAP = 1 << 16


class ExecutionError(ValueError):
    pass


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
    """TopN result: [(row_id, count)] (pilosa_tpu/executor.py:63-71)."""


class RowIdentifiers(list):
    """Rows result: ascending row ids (executor.py:73-79)."""


class GroupCounts(list):
    """GroupBy result: [{"group": [...], "count": n}] (executor.py:81-82)."""


class Executor:
    def __init__(self, holder, device="cuda"):
        self.holder = holder
        self.runner = DeviceRunner(device)
        self.residency = DeviceResidency(self.runner)
        self.hybrid = HybridManager()
        # PILOSA_TPU_TORCH_BATCH=0: one launch per Count and per Sum, no
        # coalescing
        batch = os.environ.get("PILOSA_TPU_TORCH_BATCH", "1") != "0"
        self.batcher = CountBatcher() if batch else None
        self.sum_batcher = PlaneSumBatcher() if batch else None
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
        }

    def clear_caches(self) -> None:
        """Drop every resident leaf, leaf statistic and TopN merge
        (index/field deletion: a recreated schema object restarts its
        generations and versions)."""
        self.residency.clear()
        self.hybrid.clear_stats()
        with self._topn_memo_lock:
            self._topn_merge_memo.clear()

    # ------------------------------------------------------------------ API

    def execute(self, index_name: str, query,
                shards: Optional[list[int]] = None) -> list:
        """Execute PQL; returns one result per call. An envelope of
        Set/Clear calls only goes through the IngestBatcher while
        PILOSA_TPU_TORCH_INGEST is not 0; what it declines runs per bit."""
        if isinstance(query, str):
            # the linear mutation scanner first: bulk envelopes of unique
            # columns would only churn the parse cache
            query = parse_mutations_fast(query) or parse_string_cached(query)
        if not isinstance(query, Query):
            raise TypeError("query must be a PQL string or Query")
        index = self.holder.index(index_name)
        if index is None:
            raise ExecutionError(f"index not found: {index_name}")
        if (query.calls and ingest_env_enabled()
                and all(c.name in ("Set", "Clear") for c in query.calls)):
            handled = self._execute_ingest(index, query)
            if handled is not None:
                return handled
        with self._fence(index.name).read():
            return [self._execute_call(index, call, shards)
                    for call in query.calls]

    def _fence(self, index_name: str) -> ApplyFence:
        """The index's ApplyFence: reads share it, a batch apply (with its
        patches) holds it alone."""
        fence = self._fences.get(index_name)
        if fence is None:
            with self._ingest_lock:
                fence = self._fences.setdefault(index_name, ApplyFence())
        return fence

    def _execute_call(self, index: Index, call: Call, shards):
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

    def _set_field(self, index: Index, field_name: str):
        f = index.field(field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        if f.options.type != "set":
            raise NotPortedError(
                f"field type {f.options.type!r} not ported yet")
        return f

    @staticmethod
    def _row_id(value) -> int:
        if isinstance(value, bool):
            return 1 if value else 0
        if isinstance(value, str):
            raise NotPortedError("string keys not ported yet")
        return int(value)

    @staticmethod
    def _fragments(index: Index, field_name: str, view_name: str,
                   shards: list) -> list:
        f = index.field(field_name)
        view = f.view(view_name) if f is not None else None
        return [None if view is None else view.fragment(s) for s in shards]

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
        key = ("row", index.name, field_name, view_name, row_id,
               tuple(shards), gens)

        def make():
            twin = self._dense_from_twin(index, field_name, view_name,
                                         shards, row_id, frags, gens)
            if twin is not None:
                return twin
            out = np.zeros((len(shards), WORDS_PER_SHARD), dtype=np.uint32)
            for i, fr in enumerate(frags):
                if fr is not None:
                    out[i] = fr.row_dense(row_id)
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
        key = ("sparse", index.name, field_name, view_name, row_id,
               tuple(shards), slots, gens)

        def make():
            arr = np.full((len(shards), slots), hy.SPARSE_SENTINEL,
                          dtype=np.int32)
            for i, fr in enumerate(frags):
                if fr is not None:
                    cols = fr.row_columns(row_id)
                    n = min(cols.size, slots)
                    arr[i, :n] = cols[:n]
            self.hybrid.record_upload("sparse", arr.nbytes)
            return self.runner.put_index_leaf(arr)

        return self.residency.leaf(key, make)

    def _row_leaf_run_dev(self, index: Index, field_name: str,
                          view_name: str, shards: list, row_id: int,
                          frags: list, gens: tuple, slots: int):
        """Resident run leaf int32[S, 2, slots]: each shard's intervals
        straight from its containers (Fragment.row_runs), RUN_SENTINEL-
        padded (executor.py:739-783)."""
        key = ("run", index.name, field_name, view_name, row_id,
               tuple(shards), slots, gens)

        def make():
            arr = np.full((len(shards), 2, slots), hy.RUN_SENTINEL,
                          dtype=np.int32)
            for i, fr in enumerate(frags):
                if fr is not None:
                    arr[i] = hy.runs_from_intervals(fr.row_runs(row_id),
                                                    slots)
            self.hybrid.record_upload("run", arr.nbytes)
            return self.runner.put_index_leaf(arr)

        return self.residency.leaf(key, make)

    def _chosen_leaf(self, index: Index, field_name: str, shards: list,
                     row_id: int) -> tuple:
        """(leaf, kind) of one row in the form the chooser picks."""
        rep, slots, frags, gens = planner.choose_representation(
            self.hybrid, index, field_name, VIEW_STANDARD, shards, row_id)
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
                           ("Dense", "row")):
            k = by_kind.get(kind, {})
            out[f"resident{name}Leaves"] = k.get("entries", 0)
            out[f"resident{name}Bytes"] = k.get("bytes", 0)
        return out

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
            return leaf(self.residency.leaf(
                ("zeros", len(shards)),
                lambda: np.zeros((len(shards), WORDS_PER_SHARD),
                                 dtype=np.uint32)))

        def walk(c: Call):
            if c.name == "Row":
                field_name = c.field_arg()
                self._set_field(index, field_name)
                row_id = self._row_id(c.args[field_name])
                return leaf(*self._chosen_leaf(index, field_name, shards,
                                               row_id))
            if c.name in ("Union", "Xor"):
                if not c.children:  # zero-arg Union()/Xor(): empty row
                    return zeros()
                op = "or" if c.name == "Union" else "xor"
                return (op, *[walk(ch) for ch in c.children])
            if c.name in ("Intersect", "Difference"):
                if not c.children:
                    raise ExecutionError(
                        f"{c.name}() requires at least one argument")
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
                return leaf(self._range_leaf_dev(index, c, shards))
            raise ExecutionError(f"expected bitmap call, got {c.name}")

        program = walk(call)
        return program, leaves, kinds

    def _eval_program(self, program, leaves: list, kinds: list) -> tuple:
        """(kind, device result) of a compiled program: an all-dense one
        through row_leaves_dev, a hybrid one through eval_hybrid with the
        sparse∩dense (and sparse&~dense) nodes on the kernel."""
        if "sparse" not in kinds and "run" not in kinds:
            return "dense", self.runner.row_leaves_dev(leaves, program)
        return hy.eval_hybrid(program, leaves, kinds, WORDS_PER_SHARD,
                              kernels.sparse_intersect_dense,
                              kernels.sparse_difference_dense)

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

    def _composed_row_dev(self, index: Index, call: Call, shards: list):
        """[S, W] device result of a bitmap call tree (a Sum/Min/Max or
        GroupBy filter, a TopN Src)."""
        return self._eval_program_dense(*self._compile(index, call, shards))

    def _execute_bitmap_call(self, index: Index, call: Call, shards) -> Row:
        """A Row result: a sparse root gives its columns straight from the
        index array, anything else from the planes."""
        shards = self._query_shards(index, shards)
        program, leaves, kinds = self._compile(index, call, shards)
        kind, arr = self._eval_program(program, leaves, kinds)
        if kind == "sparse":
            host = arr.cpu().numpy()
            per_shard = [r[r < hy.SPARSE_SENTINEL].astype(np.int64)
                         for r in host]
        else:
            if kind == "run":
                arr = hy.run_to_dense(arr)
            dense = arr.contiguous().cpu().numpy().view(np.uint32)
            per_shard = [columns_from_dense(d) for d in dense]
        out = Row()
        for shard, cols in zip(shards, per_shard):
            if cols.size:
                out.segments[shard] = (cols.astype(np.uint64)
                                       + np.uint64(shard * SHARD_WIDTH))
        return out

    def _execute_count(self, index: Index, call: Call, shards) -> int:
        if len(call.children) != 1:
            raise ExecutionError("Count() takes exactly one argument")
        child = call.children[0]
        if child.name in ("Union", "Xor") and not child.children:
            return 0
        shards = self._query_shards(index, shards)
        program, leaves, kinds = self._compile(index, child, shards)
        if "sparse" in kinds or "run" in kinds:
            # before the batcher: its kernels read only [S, W] planes
            return hy.hybrid_count(program, leaves, kinds, WORDS_PER_SHARD,
                                   kernels.sparse_intersect_dense,
                                   kernels.sparse_difference_dense)
        if self.batcher is not None:
            # concurrent Counts coalesce into one pair-stream launch
            if program == ("leaf", 0) and len(leaves) == 1:
                return self.batcher.count("id", leaves[0], None)
            if (len(leaves) == 2 and len(program) == 3
                    and program[0] in _BATCHABLE_OPS
                    and program[1] == ("leaf", 0)
                    and program[2] == ("leaf", 1)):
                return self.batcher.count(program[0], leaves[0], leaves[1])
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
        if "_start" in c.args or "_end" in c.args:
            raise NotPortedError("time ranges not ported yet")
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
        exists = self._bsi_exists(index, f, shards, state)
        op = cond.op

        def empty():
            return self.runner.put_leaf(
                np.zeros((len(shards), WORDS_PER_SHARD), dtype=np.uint32))

        def sweep(value: int, bop: str):
            planes = self._bsi_planes(index, f, shards, state)
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
        fn = bsi.bsi_min_packed if is_min else bsi.bsi_max_packed
        packed = fn(planes, cand).cpu().numpy().astype(np.int64)  # one fetch
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
        # the attribute filter exists only when both are given
        if call.string_arg("attrName") and call.args.get("attrValues") is not None:
            raise NotPortedError("TopN attrName/attrValues (row attributes) "
                                 "not ported yet")
        if ids_arg is not None:
            ids = list(ids_arg)
            if src is None:
                pairs = self._host_row_counts(f, shards, ids)
            else:
                pairs = self._exact_counts(index, f, shards, ids, src,
                                           tanimoto)
        else:
            cand_ids, cand_counts = self._topn_candidate_arrays(index, f,
                                                                shards)
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
        """Ranking by |row & src| (executor.py:1968-2064): candidates in
        count-desc blocks of TOPN_BLOCK, recounted on the device, stopping
        once the next cached count (an upper bound of every remaining
        intersection) cannot beat the n-th best. Ties are exact on the host
        by (count, -row_id). The JAX package first tries a sparse host path
        that needs every fragment frozen (_topn_src_sparse); the port has
        no frozen store, so it always walks densely, as the JAX package
        does over mutable fragments. The answers are the same."""
        if tanimoto:
            # tanimoto > T/100 needs |row| in (|src| T/100, |src| 100/T):
            # rows outside the band are dropped unread, tested on exact
            # counts (a cached count can be short of a row's total)
            scount = int(kernels.topn_counts_packed([src], src)[2, 0])
            lo, hi = scount * tanimoto / 100, scount * 100 / tanimoto
            exact = self._host_row_count_arr(f, shards, cand_ids)
            keep = (exact > lo) & (exact < hi)
            cand_ids, cand_counts = cand_ids[keep], exact[keep]
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
        if isinstance(call.args.get("previous"), str):
            raise NotPortedError("Rows(previous=<key>): keyed fields not "
                                 "ported yet")
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
        row's per-shard generations, built row by row from the host."""
        frags = self._fragments(index, field_name, VIEW_STANDARD, shards)
        gens = tuple(tuple(0 if fr is None else fr.row_generation(rid)
                           for fr in frags) for rid in row_ids)
        key = ("rows_slab", index.name, field_name, VIEW_STANDARD,
               tuple(shards), tuple(row_ids), gens)

        def make():
            slab = torch.empty((len(row_ids), len(shards), WORDS_PER_SHARD),
                               dtype=torch.int32, device=self.runner.device)
            host = np.zeros((len(shards), WORDS_PER_SHARD), dtype=np.uint32)
            for i, rid in enumerate(row_ids):
                for j, fr in enumerate(frags):
                    host[j] = 0 if fr is None else fr.row_dense(rid)
                slab[i].copy_(planes_to_tensor(host, "cpu"))
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
            src = filt if filt is not None else torch.zeros_like(slab0[0])
            packed = kernels.topn_counts_packed(slab0, src).cpu().numpy()
            counts = packed[0] if filt is not None else packed[1]
            self._count_sync()
            live = np.nonzero(counts)[0]
            comb, counts = [live], counts[live]
        else:
            if filt is not None:
                slab0 = torch.bitwise_and(slab0, filt)
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

    def _write_field(self, index: Index, call: Call):
        field_name = call.field_arg()
        f = index.field(field_name)
        if f is not None and f.options.type == "int":
            return f
        return self._set_field(index, field_name)

    def _execute_set(self, index: Index, call: Call) -> bool:
        col = self._column(call)
        f = self._write_field(index, call)
        if f.options.type == "int":
            changed = f.set_value(col, int(call.args[f.name]))
        else:
            if "_timestamp" in call.args:
                raise NotPortedError("timestamps not ported yet")
            changed = f.set_bit(self._row_id(call.args[f.name]), col)
        index.mark_exists([col])
        return changed

    def _execute_clear(self, index: Index, call: Call) -> bool:
        col = self._column(call)
        f = self._write_field(index, call)
        if f.options.type == "int":
            return f.clear_value(col)
        return f.clear_bit(self._row_id(call.args[f.name]), col)

    @staticmethod
    def _column(call: Call) -> int:
        col = call.args.get("_col")
        if isinstance(col, str):
            raise NotPortedError("string keys not ported yet")
        if col is None:
            raise ExecutionError(f"{call.name}() requires a column")
        return int(col)

    # ------------------------------------------------ coalesced ingest

    def _ingest_mutation(self, index: Index, call: Call, fields: dict):
        """One Set/Clear -> a Mutation, or None where only the per-bit path
        answers as it does (executor.py:3169): a missing field (its error),
        a field that is not a set field (int fields write per plane),
        timestamps, string keys. `fields` caches field resolution across
        the envelope (False: not batchable)."""
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
            if f is None or f.options.type != "set":
                fields[fname] = False
                return None
            fields[fname] = f
        elif f is False:
            return None
        if args.get("_timestamp") is not None:
            return None
        col, row = args["_col"], args[fname]
        if isinstance(col, str) or isinstance(row, str):
            return None
        return Mutation(call.name == "Set", fname, self._row_id(row),
                        int(col))

    def _ingest_prepare(self, index: Index, query: Query):
        """The Mutations of an all-Set/Clear query, or None for the per-bit
        path (executor.py:3212)."""
        muts: list = []
        fields: dict = {}
        try:
            for call in query.calls:
                m = self._ingest_mutation(index, call, fields)
                if m is None:
                    return None
                muts.append(m)
        except ExecutionError:
            raise
        except Exception:  # noqa: BLE001 — any oddity: the per-bit path decides
            return None
        return muts

    @staticmethod
    def _ingest_unpack(outcomes: list) -> list:
        """Per-call results of one request's outcomes; the first error
        raises (executor.py:3240)."""
        results = []
        for status, val in outcomes:
            if status == "err":
                raise val
            results.append(val)
        return results

    def _execute_ingest(self, index: Index, query: Query) -> Optional[list]:
        """Queue the query's mutations under the index's key and wait for a
        batch leader to apply them (executor.py:3252); None: the per-bit
        path serves the query."""
        muts = self._ingest_prepare(index, query)
        if muts is None:
            return None
        return self._ingest_unpack(self.ingest.submit((index.name,), muts))

    def _apply_ingest_batch(self, index_name: str, muts: list) -> list:
        """The IngestBatcher's apply, on the batch leader's thread."""
        index = self.holder.index(index_name)
        if index is None:
            e = ExecutionError(f"index not found: {index_name}")
            return [("err", e)] * len(muts)
        with self._fence(index_name).apply():
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
                    hyb.observe(row_key, card, run_stats=(
                        (frag.row_interval_count(r),) if read_runs else None))
                    hybrid_evals += 1
            if any(m.is_set for _, m in items):
                set_shards.setdefault(fname, []).append(shard)
                set_cols_by_shard.setdefault(shard, set()).update(
                    m.col for _, m in items if m.is_set)
            with self._ingest_lock:
                st = self.ingest_stats
                st["appliedBatches"] += 1
                st["walAppends"] += wal_appends
                st["walOps"] += wal_ops
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
