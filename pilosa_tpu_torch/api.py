"""API: the validated facade over holder + executor.

Trimmed port of pilosa_tpu/api.py: create/delete index (with
trackExistence), create field, bulk imports of bits and of int values
with existence marking (api.py:820-842), queries, schema and status.
Result JSON is the reference's (api.py:567-603) for the result types of
this slice: Row, ValCount ({"value", "count"}), Pairs ([{"id", "count"}]),
RowIdentifiers ({"rows": [...]}), GroupCounts (a list), int and bool.

Per-request profiling (api.py:109-125, :270-360): a query gets a
QueryProfile when the request asks (?profile=true) or while
long_query_time > 0; such a query also gets a trace id for the whole
request. Queries slower than long_query_time land in query_history
(GET /debug/query-history) with their profile. A profiled query that
succeeds feeds the planner's calibration ring (api.py:320-331), and
explain() answers ?explain=true (:399-440).
"""

from __future__ import annotations

import time
import uuid
from datetime import datetime, timezone
from typing import Optional

import numpy as np

from pilosa_tpu_torch import __version__, planner
from pilosa_tpu_torch.executor import (
    ExecutionError,
    Executor,
    GroupCounts,
    Pairs,
    RowIdentifiers,
    ValCount,
)
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.pql import parse_string_cached
from pilosa_tpu_torch.pql.ast import WRITE_CALLS
from pilosa_tpu_torch.pql.parser import parse_mutations_fast
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import tracing


class ApiError(Exception):
    def __init__(self, msg: str, status: int = 400, code: str = ""):
        super().__init__(msg)
        self.status = status
        self.code = code


class NotFoundError(ApiError):
    def __init__(self, msg: str):
        super().__init__(msg, status=404)


class ConflictError(ApiError):
    def __init__(self, msg: str):
        super().__init__(msg, status=409)


class API:
    def __init__(self, holder: Holder, executor: Executor):
        self.holder = holder
        self.executor = executor
        self.node_id = str(uuid.uuid4())
        self.uri = ""  # set by Server once the listener is bound
        self.start_time = time.monotonic()
        # slow-query threshold in seconds (0: off), and the ring of the
        # queries over it
        self.long_query_time = 0.0
        self.query_history = qprofile.QueryHistory(100)

    # -- queries ------------------------------------------------------------

    def query_results(self, index_name: str, pql: str,
                      shards: Optional[list[int]] = None,
                      profile: bool = False) -> list:
        """Execute PQL and return the raw results; the query's profile,
        when it had one, is published in qprofile.last_profile."""
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        slow_armed = self.long_query_time > 0
        profiling = profile or slow_armed
        trace_tok = None
        if profiling and tracing.current_trace_id.get() is None:
            # one trace id for the whole request: the history entry, the
            # profile and the spans join on it
            trace_tok = tracing.current_trace_id.set(tracing.new_trace_id())
        prof = prof_tok = None
        if profiling and qprofile.current_profile.get() is None:
            prof = qprofile.QueryProfile(
                trace_id=tracing.current_trace_id.get() or "",
                node_id=self.node_id, index=index_name,
                pql=qprofile.truncate_pql(pql))
            prof_tok = qprofile.current_profile.set(prof)
        start = time.perf_counter()
        query = results = None
        try:
            # Set/Clear envelopes take the linear scanner: their unique
            # columns would only churn the parse cache
            query = parse_mutations_fast(pql) or parse_string_cached(pql)
            results = self.executor.execute(index_name, query, shards=shards)
            return results
        except (ExecutionError, ValueError) as e:
            raise ApiError(str(e))
        finally:
            elapsed = time.perf_counter() - start
            if prof_tok is not None:
                qprofile.current_profile.reset(prof_tok)
            if prof is not None:
                prof.finish()
                if results is not None:
                    # each plan node's estimate beside its call's result
                    planner.record_calibration(prof, query.calls, results)
            qprofile.last_profile.set(prof)
            if slow_armed and elapsed > self.long_query_time:
                self.query_history.append({
                    "time": datetime.now(timezone.utc).isoformat(),
                    "index": index_name,
                    "pql": qprofile.truncate_pql(pql),
                    "elapsed": round(elapsed, 6),
                    "traceId": tracing.current_trace_id.get() or "-",
                    "profile": prof.to_dict() if prof is not None else None,
                })
            if trace_tok is not None:
                tracing.current_trace_id.reset(trace_tok)

    def query(self, index_name: str, pql: str,
              shards: Optional[list[int]] = None,
              profile: bool = False) -> dict:
        """POST /index/{index}/query; `profile` adds the query's profile
        tree under "profile"."""
        results = self.query_results(index_name, pql, shards=shards,
                                     profile=profile)
        out = {"results": [self._result_to_json(r) for r in results]}
        if profile:
            prof = qprofile.last_profile.get()
            if prof is not None:
                out["profile"] = prof.to_dict()
        return out

    def explain(self, index_name: str, pql: str,
                shards: Optional[list[int]] = None) -> dict:
        """POST /index/{index}/query?explain=true: the planned tree of each
        call, executing nothing (Executor.explain_call); write calls and
        calls without a device plan say so. The calibration ring's
        aggregates ride along."""
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            query = parse_string_cached(pql)
        except ValueError as e:
            raise ApiError(str(e))
        out = []
        for call in query.calls:
            if call.name in WRITE_CALLS:
                out.append({"call": call.name, "planned": False,
                            "note": "write call: nothing to plan"})
                continue
            if call.name not in planner.PLANNED_CALLS:
                out.append({"call": call.name, "planned": False,
                            "note": "call is executed host-side; no "
                                    "device plan"})
                continue
            try:
                out.append(self.executor.explain_call(index, call, shards))
            except (ExecutionError, ValueError) as e:
                raise ApiError(str(e))
        return {"index": index_name, "explain": out,
                "calibration": planner.calibration.snapshot(limit=0)}

    @staticmethod
    def _result_to_json(result):
        if isinstance(result, Row):
            d = result.to_json_dict()
            d.setdefault("attrs", {})
            return d
        if isinstance(result, ValCount):
            return result.to_json_dict()
        if isinstance(result, Pairs):
            return [{"id": i, "count": c} for i, c in result]
        if isinstance(result, RowIdentifiers):
            return {"rows": list(result)}
        if isinstance(result, GroupCounts):
            return list(result)
        return result  # int / bool

    # -- schema -------------------------------------------------------------

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True):
        if keys:
            raise ApiError("keyed indexes not ported yet")
        if self.holder.index(name) is not None:
            raise ConflictError(f"index already exists: {name}")
        try:
            return self.holder.create_index(name,
                                            track_existence=track_existence)
        except ValueError as e:
            raise ApiError(str(e))

    def delete_index(self, name: str) -> None:
        try:
            self.holder.delete_index(name)
        except KeyError as e:
            raise NotFoundError(str(e.args[0]))
        self.executor.clear_caches()

    def create_field(self, index_name: str, field_name: str,
                     options: Optional[FieldOptions] = None):
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        if index.field(field_name) is not None:
            raise ConflictError(f"field already exists: {field_name}")
        try:
            return index.create_field(field_name, options)
        except ValueError as e:  # NotPortedError included
            raise ApiError(str(e))

    def schema(self) -> dict:
        return {"indexes": self.holder.schema()}

    # -- imports ------------------------------------------------------------

    def import_bits(self, index_name: str, field_name: str,
                    row_ids, column_ids, clear: bool = False) -> None:
        """Bulk import of (row, column) bits; marks the columns in the
        existence field unless clearing."""
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        f = index.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        if f.options.type != "set":
            raise ApiError(f"field type {f.options.type!r} not ported yet")
        if row_ids is None or column_ids is None:
            raise ApiError("import requires rows and columns")
        rows = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        cols = np.asarray(column_ids, dtype=np.int64).reshape(-1)
        if rows.shape != cols.shape:
            raise ApiError("row/column length mismatch")
        if rows.size and (rows.min() < 0 or cols.min() < 0):
            raise ApiError("row and column ids must be non-negative")
        f.import_bits(rows, cols, clear=clear)
        if not clear:
            # clears do not retract existence: other fields may still
            # hold the column
            index.mark_exists(cols)

    def import_values(self, index_name: str, field_name: str,
                      column_ids, values) -> None:
        """Bulk import of int values (the last value of a column wins);
        marks the columns in the existence field."""
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        f = index.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        if column_ids is None or values is None:
            raise ApiError("import requires columns and values")
        cols = np.asarray(column_ids, dtype=np.int64).reshape(-1)
        if cols.size and cols.min() < 0:
            raise ApiError("column ids must be non-negative")
        try:
            f.import_values(cols, values)
        except ValueError as e:
            raise ApiError(str(e))
        index.mark_exists(cols)

    # -- status -------------------------------------------------------------

    def status(self) -> dict:
        dev = self.executor.runner.device
        return {"state": "NORMAL",
                "nodes": [{"id": self.node_id, "uri": self.uri,
                           "isCoordinator": True}],
                "localID": self.node_id,
                "coordinatorID": self.node_id,
                "uptimeSeconds": int(time.monotonic() - self.start_time),
                "version": __version__,
                "device": str(dev)}

