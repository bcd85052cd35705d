"""API: the validated facade over holder + executor.

Trimmed port of pilosa_tpu/api.py: create/delete index (with
trackExistence), create field, bulk imports of bits and of int values
with existence marking (api.py:820-842), queries, schema and status.
Result JSON is the reference's (api.py:567-603) for the result types of
this slice: Row, ValCount ({"value", "count"}), Pairs ([{"id", "count"}]),
RowIdentifiers ({"rows": [...]}), GroupCounts (a list), int and bool.
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

import numpy as np

from pilosa_tpu_torch import __version__
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
from pilosa_tpu_torch.pql.parser import parse_mutations_fast


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

    # -- queries ------------------------------------------------------------

    def query_results(self, index_name: str, pql: str,
                      shards: Optional[list[int]] = None) -> list:
        """Execute PQL and return the raw results."""
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            # Set/Clear envelopes take the linear scanner: their unique
            # columns would only churn the parse cache
            query = parse_mutations_fast(pql) or parse_string_cached(pql)
            return self.executor.execute(index_name, query, shards=shards)
        except (ExecutionError, ValueError) as e:
            raise ApiError(str(e))

    def query(self, index_name: str, pql: str,
              shards: Optional[list[int]] = None) -> dict:
        """POST /index/{index}/query."""
        results = self.query_results(index_name, pql, shards=shards)
        return {"results": [self._result_to_json(r) for r in results]}

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

