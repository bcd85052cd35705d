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

Not(x) is existence &~ x (executor.py:1317-1322). Left out: the planner
and plan cache, hybrid sparse/run leaves, heat, the cluster, key
translation and the MinMaxBatcher. None of them changes an answer. Calls,
field types and options outside the slice raise NotPortedError (a 400 at
the API).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pilosa_tpu_torch.constants import (
    EXISTENCE_FIELD_NAME,
    SHARD_WIDTH,
    WORDS_PER_SHARD,
)
from pilosa_tpu_torch.models.field import NotPortedError
from pilosa_tpu_torch.models.index import Index
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.ops import bsi
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitvector import band, columns_from_dense
from pilosa_tpu_torch.parallel.batcher import CountBatcher, PlaneSumBatcher
from pilosa_tpu_torch.parallel.mesh import DeviceRunner
from pilosa_tpu_torch.parallel.residency import DeviceResidency
from pilosa_tpu_torch.pql import Call, Query, parse_string_cached
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


class Executor:
    def __init__(self, holder, device="cuda"):
        self.holder = holder
        self.runner = DeviceRunner(device)
        self.residency = DeviceResidency(self.runner)
        # PILOSA_TPU_TORCH_BATCH=0: one launch per Count and per Sum, no
        # coalescing
        batch = os.environ.get("PILOSA_TPU_TORCH_BATCH", "1") != "0"
        self.batcher = CountBatcher() if batch else None
        self.sum_batcher = PlaneSumBatcher() if batch else None

    def clear_caches(self) -> None:
        """Drop every resident leaf (index/field deletion: a recreated
        schema object restarts its generations)."""
        self.residency.clear()

    # ------------------------------------------------------------------ API

    def execute(self, index_name: str, query,
                shards: Optional[list[int]] = None) -> list:
        """Execute PQL; returns one result per call."""
        if isinstance(query, str):
            query = parse_string_cached(query)
        if not isinstance(query, Query):
            raise TypeError("query must be a PQL string or Query")
        index = self.holder.index(index_name)
        if index is None:
            raise ExecutionError(f"index not found: {index_name}")
        return [self._execute_call(index, call, shards)
                for call in query.calls]

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
        row generations (a write changes the key)."""
        if frags is None:
            frags = self._fragments(index, field_name, view_name, shards)
        if gens is None:
            gens = tuple(0 if fr is None else fr.row_generation(row_id)
                         for fr in frags)
        key = ("row", index.name, field_name, view_name, row_id,
               tuple(shards), gens)

        def make() -> np.ndarray:
            out = np.zeros((len(shards), WORDS_PER_SHARD), dtype=np.uint32)
            for i, fr in enumerate(frags):
                if fr is not None:
                    out[i] = fr.row_dense(row_id)
            return out

        return self.residency.leaf(key, make)

    def _compile(self, index: Index, call: Call, shards: list):
        """Walk the call tree -> (program, leaves)."""
        leaves: list = []

        def leaf(t):
            leaves.append(t)
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
                return leaf(self._row_leaf_dev(index, field_name, shards,
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
                ex = leaf(self._row_leaf_dev(index, EXISTENCE_FIELD_NAME,
                                             shards, 0))
                return ("andnot", ex, walk(c.children[0]))
            if c.name == "Range":
                return leaf(self._range_leaf_dev(index, c, shards))
            raise ExecutionError(f"expected bitmap call, got {c.name}")

        program = walk(call)
        return program, leaves

    def _execute_bitmap_call(self, index: Index, call: Call, shards) -> Row:
        shards = self._query_shards(index, shards)
        program, leaves = self._compile(index, call, shards)
        dense = self.runner.row_leaves(leaves, program)
        out = Row()
        for i, shard in enumerate(shards):
            cols = columns_from_dense(dense[i])
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
        program, leaves = self._compile(index, child, shards)
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
        slab from the host rows (in-place patching is not ported yet)."""
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
            program, leaves = self._compile(index, call.children[0], shards)
            cand = band(cand, self.runner.row_leaves_dev(leaves, program))
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
