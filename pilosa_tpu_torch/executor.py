"""Query executor: the dense PQL read path and the bit writes.

Trimmed port of pilosa_tpu/executor.py. For a query the executor

  1. walks the bitmap call tree and resolves every Row (and the existence
     row of Not) to a device-resident [S, W] leaf through the
     generation-keyed DeviceResidency (executor.py:640, :1189-1331),
  2. compiles the tree to the nested-tuple program of parallel/mesh.py,
  3. evaluates it on the device: Count of a 1- or 2-leaf program goes
     through the CountBatcher (pair-stream kernel), every other Count
     through DeviceRunner.count_total_leaves (program_count kernel, 3+-way
     AND chains included), Row results through row_leaves_dev,
  4. finishes counts in int64 and Row segments on the host.

Not(x) is existence &~ x (executor.py:1317-1322). Left out: the planner
and plan cache, hybrid sparse/run leaves, heat, the cluster, key
translation. None of them changes an answer. Calls, field types and
options outside the slice raise NotPortedError (a 400 at the API).
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
from pilosa_tpu_torch.ops.bitvector import columns_from_dense
from pilosa_tpu_torch.parallel.batcher import CountBatcher
from pilosa_tpu_torch.parallel.mesh import DeviceRunner
from pilosa_tpu_torch.parallel.residency import DeviceResidency
from pilosa_tpu_torch.pql import Call, Query, parse_string_cached

BITMAP_CALLS = {"Row", "Union", "Intersect", "Difference", "Xor", "Not"}
_BATCHABLE_OPS = ("and", "or", "xor", "andnot")


class ExecutionError(ValueError):
    pass


class Executor:
    def __init__(self, holder, device="cuda"):
        self.holder = holder
        self.runner = DeviceRunner(device)
        self.residency = DeviceResidency(self.runner)
        # PILOSA_TPU_TORCH_BATCH=0: one launch per Count, no coalescing
        self.batcher = (CountBatcher()
                        if os.environ.get("PILOSA_TPU_TORCH_BATCH", "1") != "0"
                        else None)

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

    def _row_leaf_dev(self, index: Index, field_name: str, shards: list,
                      row_id: int):
        """Device-resident [S, W] leaf of one row, keyed by the per-shard
        row generations (a write changes the key)."""
        f = index.field(field_name)
        view = f.view(VIEW_STANDARD) if f is not None else None
        frags = [None if view is None else view.fragment(s) for s in shards]
        gens = tuple(0 if fr is None else fr.row_generation(row_id)
                     for fr in frags)
        key = ("row", index.name, field_name, VIEW_STANDARD, row_id,
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
            if c.name in BITMAP_CALLS or c.name == "Range":
                raise NotPortedError(f"call {c.name}() not ported yet")
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

    # --------------------------------------------------------------- writes

    def _execute_set(self, index: Index, call: Call) -> bool:
        col = self._column(call)
        f = self._set_field(index, call.field_arg())
        if "_timestamp" in call.args:
            raise NotPortedError("timestamps not ported yet")
        changed = f.set_bit(self._row_id(call.args[f.name]), col)
        index.mark_exists([col])
        return changed

    def _execute_clear(self, index: Index, call: Call) -> bool:
        col = self._column(call)
        f = self._set_field(index, call.field_arg())
        return f.clear_bit(self._row_id(call.args[f.name]), col)

    @staticmethod
    def _column(call: Call) -> int:
        col = call.args.get("_col")
        if isinstance(col, str):
            raise NotPortedError("string keys not ported yet")
        if col is None:
            raise ExecutionError(f"{call.name}() requires a column")
        return int(col)
