"""API: the validated facade over holder + executor.

Trimmed port of pilosa_tpu/api.py: create/delete index (with keys and
trackExistence), create/delete field, bulk imports of bits (with
timestamps for a time field's views, :681-745; row and column keys
translated first, :680-700) and of int values with existence marking
(:808-842), the per-shard roaring import (:844-880), queries, the CSV
export (:884), schema, status, info, version and the rank caches'
recount (:1011).
Result JSON is the reference's (api.py:561-603): Row ({"columns"}, or
{"keys"} on a keyed index, and "attrs"), ValCount ({"value", "count"}),
Pairs ([{"id", "count"}], with "key" on a keyed field), RowIdentifiers
({"rows": [...]}, or {"rows": null, "keys": [...]}), GroupCounts (a
list), int, bool and null (the attribute writes). columnAttrs=true adds
"columnAttrSets" (:543-559); excludeRowAttrs and excludeColumns empty
every Row result's attributes or columns (:305-314).

Per-request profiling (api.py:109-125, :270-360): a query gets a
QueryProfile when the request asks (?profile=true) or while
long_query_time > 0; such a query also gets a trace id for the whole
request. Queries slower than long_query_time land in query_history
(GET /debug/query-history) with their profile. A profiled query that
succeeds feeds the planner's calibration ring (api.py:320-331), and
explain() answers ?explain=true (:399-440).
"""

from __future__ import annotations

import csv
import io
import os
import time
import uuid
from datetime import datetime, timezone
from typing import Optional

import numpy as np

from pilosa_tpu_torch import __version__, planner
from pilosa_tpu_torch.constants import SHARD_WIDTH
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
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.pql import parse_string_cached
from pilosa_tpu_torch.pql.ast import WRITE_CALLS
from pilosa_tpu_torch.pql.parser import parse_mutations_fast
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import tracing
from pilosa_tpu_torch.utils.translate import TranslateStore


_EPOCH = datetime(1970, 1, 1)


def import_timestamps(timestamps) -> np.ndarray:
    """An import's timestamps as datetime64[us] with NaT for "none", read
    as the JAX package's import_bits reads them (api.py:697-741): epoch
    seconds (0 and None: no timestamp) or ISO-8601 strings, with or
    without a Z; anything else is a 400. A list of plain numbers converts
    in numpy without a Python loop."""
    ts = list(timestamps)
    if set(map(type, ts)) <= {int, float, type(None)}:
        # 0 and None mean "no timestamp", as the wire's zero value does
        secs = np.asarray([0 if t is None else t for t in ts],
                          dtype=np.float64)
        us = np.round(secs * 1e6).astype(np.int64).astype("datetime64[us]")
        return np.where(secs != 0, us, np.datetime64("NaT", "us"))
    out = np.full(len(ts), np.datetime64("NaT", "us"))
    for i, t in enumerate(ts):
        if isinstance(t, str):
            try:
                t = datetime.fromisoformat(
                    t[:-1] + "+00:00" if t[-1:] in ("Z", "z") else t)
            except ValueError:
                raise ApiError(f"invalid import timestamp: {t!r}")
            if t.tzinfo is not None:
                t = t.astimezone(timezone.utc).replace(tzinfo=None)
            if t != _EPOCH:  # epoch 0 is "no timestamp" there too
                out[i] = np.datetime64(t, "us")
        elif t is None or isinstance(t, (int, float)) \
                and not isinstance(t, bool):
            if t:
                out[i] = np.datetime64(round(t * 1e6), "us")
        else:
            raise ApiError(f"invalid import timestamp: {t!r}")
    return out


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
    def __init__(self, holder: Holder, executor: Executor,
                 translate_store: Optional[TranslateStore] = None):
        self.holder = holder
        self.executor = executor
        # string keys (utils/translate.py); an in-memory store unless the
        # server gives its own
        self.translate = translate_store or TranslateStore().open()
        if executor.translator is None:
            executor.translator = self.translate
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
                      profile: bool = False,
                      exclude_row_attrs: bool = False,
                      exclude_columns: bool = False) -> list:
        """Execute PQL and return the raw results (the JSON and protobuf
        writers both read them); the query's profile, when it had one, is
        published in qprofile.last_profile. The exclude flags empty every
        Row result's attributes or columns."""
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
            if exclude_row_attrs or exclude_columns:
                for r in results:
                    if isinstance(r, Row):
                        if exclude_columns:
                            r.segments = {}
                        if exclude_row_attrs:
                            r.attrs = {}
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
              profile: bool = False, column_attrs: bool = False,
              exclude_row_attrs: bool = False,
              exclude_columns: bool = False) -> dict:
        """POST /index/{index}/query; `profile` adds the query's profile
        tree under "profile", `column_attrs` the attribute sets of the Row
        results' columns under "columnAttrSets"."""
        results = self.query_results(index_name, pql, shards=shards,
                                     profile=profile,
                                     exclude_row_attrs=exclude_row_attrs,
                                     exclude_columns=exclude_columns)
        index = self.holder.index(index_name)
        out = {"results": [self._result_to_json(index, r) for r in results]}
        if column_attrs:
            out["columnAttrSets"] = self.column_attr_sets(index_name,
                                                          results)
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

    def column_attr_sets(self, index_name: str, results: list) -> list:
        """The attributes of every column of the Row results that has any,
        ascending, with its key on a keyed index (api.py:543-559)."""
        index = self.holder.index(index_name)
        if index is None:
            return []
        cols = [r.columns() for r in results if isinstance(r, Row)]
        if not cols:
            return []
        ids = np.unique(np.concatenate(cols)).tolist()
        attrs = index.column_attrs.attrs_many(ids)
        out = []
        keys = {}
        if index.keys and attrs:
            with_attrs = sorted(attrs)
            keys = dict(zip(with_attrs,
                            self.translate.translate_columns_to_strings(
                                index.name, with_attrs)))
        for c in sorted(attrs):
            if attrs[c]:
                entry = {"id": c, "attrs": attrs[c]}
                if keys.get(c) is not None:
                    entry["key"] = keys[c]
                out.append(entry)
        return out

    def _result_to_json(self, index, result):
        if isinstance(result, Row):
            d = result.to_json_dict()
            if index is not None and index.keys:
                # a keyed index names its columns by key; a column without
                # one renders as its decimal id
                cols = d.pop("columns")
                keys = self.translate.translate_columns_to_strings(
                    index.name, cols)
                d["keys"] = [k if k is not None else str(c)
                             for c, k in zip(cols, keys)]
            d.setdefault("attrs", {})
            return d
        if isinstance(result, ValCount):
            return result.to_json_dict()
        if isinstance(result, Pairs):
            if result.row_keys is not None:
                return [{"id": int(i), "key": k, "count": c}
                        for (i, c), k in zip(result, result.row_keys)]
            return [{"id": i, "count": c} for i, c in result]
        if isinstance(result, RowIdentifiers):
            if result.row_keys is not None:
                return {"rows": None, "keys": list(result.row_keys)}
            return {"rows": list(result)}
        if isinstance(result, GroupCounts):
            return list(result)
        return result  # int / bool / None

    # -- schema -------------------------------------------------------------

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True):
        if self.holder.index(name) is not None:
            raise ConflictError(f"index already exists: {name}")
        try:
            return self.holder.create_index(name, keys=keys,
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
        except ValueError as e:
            raise ApiError(str(e))

    def delete_field(self, index_name: str, field_name: str) -> None:
        """DELETE /index/{i}/field/{f} (api.py:648): the field's files go,
        and the executor drops its resident leaves, cached results, heat
        entries, row forms and TopN merges."""
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            index.delete_field(field_name)
        except KeyError as e:
            raise NotFoundError(str(e))
        self.executor.drop_field(index_name, field_name)

    def schema(self) -> dict:
        return {"indexes": self.holder.schema()}

    def _field(self, index_name: str, field_name: str):
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        f = index.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        return index, f

    # -- imports ------------------------------------------------------------

    def import_bits(self, index_name: str, field_name: str,
                    row_ids=None, column_ids=None, clear: bool = False,
                    timestamps=None, row_keys=None,
                    column_keys=None) -> None:
        """Bulk import of (row, column) bits; marks the columns in the
        existence field unless clearing. `timestamps` (one per bit, as
        import_timestamps reads them) place a time field's bits in their
        quantum's views; other field types ignore them. Row and column
        keys, where given, are minted or looked up first (rows first, as
        api.py:688-691) and take the ids' place."""
        index, f = self._field(index_name, field_name)
        if row_keys:
            row_ids = self.translate.translate_rows(index_name, field_name,
                                                    list(row_keys))
        if column_keys:
            column_ids = self.translate.translate_columns(index_name,
                                                          list(column_keys))
        if row_ids is None or column_ids is None:
            raise ApiError("import requires rows and columns")
        rows = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        cols = np.asarray(column_ids, dtype=np.int64).reshape(-1)
        if rows.shape != cols.shape:
            raise ApiError("row/column length mismatch")
        if rows.size and (rows.min() < 0 or cols.min() < 0):
            raise ApiError("row and column ids must be non-negative")
        ts = import_timestamps(timestamps) if timestamps else None
        try:
            f.import_bits(rows, cols, ts, clear=clear)
        except ValueError as e:
            raise ApiError(str(e))
        if not clear:
            # clears do not retract existence: other fields may still
            # hold the column
            index.mark_exists(cols)

    def import_values(self, index_name: str, field_name: str,
                      column_ids=None, values=None,
                      column_keys=None) -> None:
        """Bulk import of int values (the last value of a column wins);
        marks the columns in the existence field. Column keys, where
        given, take the ids' place."""
        index, f = self._field(index_name, field_name)
        if column_keys:
            column_ids = self.translate.translate_columns(index_name,
                                                          list(column_keys))
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

    def import_roaring(self, index_name: str, field_name: str, shard: int,
                       views: dict, clear: bool = False) -> None:
        """POST /index/{i}/field/{f}/import-roaring/{shard} (:844-880):
        one serialized roaring bitmap of shard-local positions per view
        ("" is the standard view), unioned into (or cleared from) that
        view's fragment of the shard. Existence is not marked, as in the
        JAX package."""
        _, f = self._field(index_name, field_name)
        for vname, data in views.items():
            view = f.create_view_if_not_exists(vname or VIEW_STANDARD)
            frag = view.create_fragment_if_not_exists(shard)
            try:
                frag.import_roaring(data, clear=clear)
            except ValueError as e:
                raise ApiError(f"unmarshalling roaring data: {e}")
            view.refresh_rank_cache(shard)
        f.add_available_shards([shard])

    # -- export -------------------------------------------------------------

    def export_csv(self, index_name: str, field_name: str,
                   shard: int) -> str:
        """GET /export (api.py:884): "row,column" lines of the shard's
        standard view, rows ascending, columns as global ids."""
        _, f = self._field(index_name, field_name)
        view = f.view(VIEW_STANDARD)
        frag = view.fragment(shard) if view is not None else None
        buf = io.StringIO()
        w = csv.writer(buf)
        if frag is not None:
            base = shard * SHARD_WIDTH
            for rid in frag.row_ids():
                w.writerows([rid, int(c) + base]
                            for c in frag.row_columns(rid))
        return buf.getvalue()

    def recalculate_caches(self) -> None:
        """POST /recalculate-caches (api.py:1011): every view's rank caches
        rebuilt from its bits."""
        for idx in list(self.holder.indexes.values()):
            for f in list(idx.fields.values()):
                for v in list(f.views.values()):
                    for shard in v.shards():
                        v.refresh_rank_cache(shard)

    # -- status -------------------------------------------------------------

    def info(self) -> dict:
        """GET /info (api.py:943): one node of one device."""
        return {"shardWidth": SHARD_WIDTH, "cpuPhysicalCores": os.cpu_count(),
                "meshDevices": 1, "version": __version__}

    def version(self) -> str:
        return __version__

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

