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

In a cluster (api.py:181, :439-541, :746-880, :953-1087): index and field
creation and deletion are broadcast to every node; a query that is not a
fan-out sub-request (remote=False) is distributed by the executor;
query_batch answers a coordinator's /internal/query-batch envelope,
running its entries concurrently on the executor's inbound pool (so this
node's CountBatcher and PlaneSumBatcher coalesce them) and refusing a
write entry by entry; an import is split by shard and forwarded to every
owner with remote=true (forward_import_fn, forward_roaring_fn), this node
importing only what it owns; the internal reads (hosts, max_shards,
shard_nodes, translate_keys, translate_data) back the /internal/* routes,
and anti-entropy reads peers through fragment_blocks,
fragment_block_data, fragment_data and the attribute diffs
(:1020-1070); a missing fragment is a 404 with the code
`fragment-not-found`. Without a cluster, or with one node, the API is
the single node's.

Cluster-state gates (api.py:64-74, :187-192): queries and the CSV
export run in NORMAL and DEGRADED only, and so do writes and schema
changes; set-coordinator and remove-node run in RESIZING too; anything
else is a 503 "api method unavailable in cluster state <state>", the JAX
text. Membership changes (api.py:964-1011, :1054): set_coordinator
(adopted here and broadcast), remove_node (through the server's
resize_fn, which routes it to the coordinator's leave job), resize_abort
(abort_fn), drain (drain_fn; not state-gated: a lifecycle call works in
any state) and fragment_views, the donor's side of a resize copy.

Per-request profiling (api.py:109-125, :196-203, :270-375): profile_mode
(the [cluster] profile) "auto" gives a query a QueryProfile when the
request asks (?profile=true) or while long_query_time > 0, "on" gives
every query one and "off" none; PILOSA_TPU_PROFILE=0, read when the API
is made, is "off" whatever the mode. A profiled or slow-armed query also
gets a trace id for the whole request. Queries slower than
long_query_time land in query_history (GET /debug/query-history) with
their profile, and in the log (`logger`) as "<s>s SLOW QUERY <index>
<pql, cut at 256> trace=<id>". A profiled query that
succeeds feeds the planner's calibration ring (api.py:320-331), and
explain() answers ?explain=true (:399-440).

Limits, QoS and accounting (api.py:110, :233-350, :482-495, :926-940): a
query of more than max_writes_per_request write calls (an Options()
wrapper unwrapped; 0: no limit) is a 400 `too many writes in a single
request: <n> > <limit>`; a query whose deadline has expired is refused
before it is planned (counted by the QoS plane as deadline, or
deadlineRemote for a coordinator's entry); in enforce mode a query whose
class's observed cost exceeds its remaining deadline is a 503 with code
`shed`. Every query charges its principal one query (and one error when
it fails); on the coordinator the SLO tracker and the plane's per-class
cost observe it. A profiled query carries a `qos` node. query_batch
installs each entry's principal and priority beside its trace id.
/status carries `health` (health_fn, the server's node_health).
"""

from __future__ import annotations

import contextvars
import csv
import dataclasses
import io
import os
import threading
import time
import uuid
from datetime import datetime, timezone
from typing import Optional

import numpy as np

from pilosa_tpu_torch import __version__, planner, qos
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
from pilosa_tpu_torch.parallel.cluster import (
    STATE_DEGRADED,
    STATE_NORMAL,
    STATE_RESIZING,
    STATE_STARTING,
)
from pilosa_tpu_torch.pql import parse_string_cached
from pilosa_tpu_torch.pql.ast import WRITE_CALLS
from pilosa_tpu_torch.pql.parser import parse_mutations_fast
from pilosa_tpu_torch.utils import accounting
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import qctx, tracing
from pilosa_tpu_torch.utils.attrstore import attr_diff
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
    def __init__(self, msg: str, code: str = ""):
        super().__init__(msg, status=404, code=code)


class ConflictError(ApiError):
    def __init__(self, msg: str):
        super().__init__(msg, status=409)


# method -> the states it runs in (api.go:1247-1278); a method not listed
# runs in NORMAL and DEGRADED
_STATE_GATES = {
    "query": (STATE_NORMAL, STATE_DEGRADED),
    "write": (STATE_NORMAL, STATE_DEGRADED),
    "schema_read": (STATE_NORMAL, STATE_DEGRADED, STATE_RESIZING,
                    STATE_STARTING),
    "resize": (STATE_NORMAL, STATE_DEGRADED, STATE_RESIZING),
}


class API:
    def __init__(self, holder: Holder, executor: Executor,
                 translate_store: Optional[TranslateStore] = None,
                 cluster=None):
        self.holder = holder
        self.executor = executor
        # string keys (utils/translate.py, or a server's ClusterTranslator);
        # an in-memory store unless the server gives its own
        self.translate = translate_store or TranslateStore().open()
        if executor.translator is None:
            executor.translator = self.translate
        # the cluster (parallel/cluster.py), or None for a single node;
        # the server sets the hooks below
        self.cluster = cluster
        self.broadcast_fn = None  # fn(message): every other node
        self.forward_import_fn = None  # fn(uri, index, field, payload)
        # fn(uri, index, field, shard, views, clear)
        self.forward_roaring_fn = None
        self.probe_peer_fn = None  # fn(uri) -> bool: its /status answers
        # membership and lifecycle: resize_fn(event, node) routes a
        # removal to the coordinator's leave job, abort_fn() cancels the
        # coordinator's job, drain_fn(abort=) starts or cancels this
        # node's drain, drain_status_fn() and node_state_fn() ("READY" |
        # "DRAINING") report it
        self.resize_fn = None
        self.abort_fn = None
        self.drain_fn = None
        self.drain_status_fn = None
        self.node_state_fn = None
        self.node_id = cluster.local_id if cluster is not None \
            else str(uuid.uuid4())
        self.uri = ""  # set by Server once the listener is bound
        self.start_time = time.monotonic()
        # slow-query threshold in seconds (0: off), and the ring of the
        # queries over it
        self.long_query_time = 0.0
        self.logger = None  # the server's Logger: the slow-query line
        self.profile_mode = "auto"
        self._profile_killed = os.environ.get(
            "PILOSA_TPU_PROFILE", "1") == "0"
        self.cluster_events_fn = None  # fn(limit=) -> GET /cluster/events
        self.query_history = qprofile.QueryHistory(100)
        self.max_writes_per_request = 5000  # 0: no limit
        # the server replaces these from its config: the usage ledger the
        # HTTP layer's accounts charge, the [slo] objectives (an
        # availability one by default), the QoS plane (None: no plane)
        # and health_fn() -> the node's health, reported on /status
        self.usage_ledger = accounting.UsageLedger()
        self.slo = accounting.SLOTracker(
            [accounting.Objective("availability", None, None, 0.999)])
        self.qos_plane = None
        self.health_fn = None

    # -- queries ------------------------------------------------------------

    def _should_profile(self, explicit: bool) -> bool:
        """Whether a query gets a QueryProfile (profile_mode)."""
        if self._profile_killed or self.profile_mode == "off":
            return False
        if self.profile_mode == "on":
            return True
        return explicit or self.long_query_time > 0

    def _broadcast(self, msg: dict) -> None:
        if self.broadcast_fn is not None:
            self.broadcast_fn(msg)

    def _clustered(self) -> bool:
        return self.cluster is not None and len(self.cluster.nodes) > 1

    def _validate(self, gate: str) -> None:
        """503 unless the cluster's state lets `gate` run."""
        if self.cluster is None:
            return
        allowed = _STATE_GATES.get(gate, (STATE_NORMAL, STATE_DEGRADED))
        if self.cluster.state not in allowed:
            raise ApiError("api method unavailable in cluster state "
                           f"{self.cluster.state}", status=503)

    def query_results(self, index_name: str, pql: str,
                      shards: Optional[list[int]] = None,
                      profile: bool = False,
                      exclude_row_attrs: bool = False,
                      exclude_columns: bool = False,
                      remote: bool = False) -> list:
        """Execute PQL and return the raw results (the JSON and protobuf
        writers both read them); the query's profile, when it had one, is
        published in qprofile.last_profile. The exclude flags empty every
        Row result's attributes or columns; remote=True marks a fan-out
        sub-request (run here on the given shards, results as ids). A
        query of too many writes, one whose deadline has already passed
        and, in enforce mode, one whose class costs more than its
        remaining deadline are refused here, before planning."""
        self._validate("query")
        if self.holder.index(index_name) is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            # Set/Clear envelopes take the linear scanner: their unique
            # columns would only churn the parse cache
            query = parse_mutations_fast(pql) or parse_string_cached(pql)
        except ValueError as e:
            raise ApiError(str(e))
        if self.max_writes_per_request > 0:
            writes = sum(
                1 for c in query.calls
                if (c.children[0] if c.name == "Options" and c.children
                    else c).name in WRITE_CALLS)
            if writes > self.max_writes_per_request:
                raise ApiError(
                    f"too many writes in a single request: {writes} > "
                    f"{self.max_writes_per_request}")
        plane = self.qos_plane
        rem = qctx.remaining()
        if rem is not None and rem <= 0:
            if plane is not None:
                plane.record_expired(remote)
            raise qctx.QueryTimeoutError("query deadline exceeded")
        if (plane is not None and plane.mode == "enforce" and not remote
                and rem is not None):
            est_ms = plane.class_cost_ms(accounting.classify_query(query))
            if est_ms > 0 and rem * 1e3 < est_ms:
                plane.record_cost_shed()
                raise ApiError(
                    f"query shed: estimated cost {est_ms:.0f} ms exceeds "
                    f"remaining deadline {rem * 1e3:.0f} ms",
                    status=503, code="shed")
        slow_armed = self.long_query_time > 0
        profiling = self._should_profile(profile)
        trace_tok = None
        if ((profiling or slow_armed)
                and tracing.current_trace_id.get() is None):
            # one trace id for the whole request: the history entry, the
            # profile and the spans join on it
            trace_tok = tracing.current_trace_id.set(tracing.new_trace_id())
        prof = prof_tok = None
        if profiling and qprofile.current_profile.get() is None:
            prof = qprofile.QueryProfile(
                trace_id=tracing.current_trace_id.get() or "",
                node_id=self.node_id, index=index_name,
                pql=qprofile.truncate_pql(pql))
            pr = qos.current_priority.get() if qos.enabled() else None
            if pr is not None or plane is not None:
                # the class the query ran under, its deadline budget and
                # the wait estimate admission let it past
                prof.qos = {
                    "priority": pr or (plane.default_priority
                                       if plane is not None else None),
                    "deadlineMs": (round(rem * 1e3, 1)
                                   if rem is not None else None),
                    "estimatedWaitMs": (round(plane.estimated_wait_ms(), 3)
                                        if plane is not None else None),
                }
            prof_tok = qprofile.current_profile.set(prof)
        start = time.perf_counter()
        results = None
        ok = False
        try:
            results = self.executor.execute(index_name, query, shards=shards,
                                            remote=remote)
            if exclude_row_attrs or exclude_columns:
                for r in results:
                    if isinstance(r, Row):
                        if exclude_columns:
                            r.segments = {}
                        if exclude_row_attrs:
                            r.attrs = {}
            ok = True
            return results
        except (ExecutionError, ValueError) as e:
            raise ApiError(str(e))
        finally:
            elapsed = time.perf_counter() - start
            if prof_tok is not None:
                qprofile.current_profile.reset(prof_tok)
            if prof is not None:
                prof.finish()
                if ok and not remote:
                    # each plan node's estimate beside its call's result
                    planner.record_calibration(prof, query.calls, results)
            qprofile.last_profile.set(prof)
            acct = accounting.current_account.get()
            if acct is not None:
                acct.charge(queries=1, errors=0 if ok else 1)
            if not remote:
                # the user's query, once: a coordinator's entries on the
                # remotes are not the objective's events
                qclass = accounting.classify_query(query)
                if self.slo is not None:
                    self.slo.observe(qclass, elapsed, ok)
                if plane is not None and ok:
                    plane.observe_service(qclass, elapsed * 1e3)
            if slow_armed and elapsed > self.long_query_time:
                trace_id = tracing.current_trace_id.get() or "-"
                short_pql = qprofile.truncate_pql(pql)
                self.query_history.append({
                    "time": datetime.now(timezone.utc).isoformat(),
                    "index": index_name,
                    "pql": short_pql,
                    "elapsed": round(elapsed, 6),
                    "traceId": trace_id,
                    "profile": prof.to_dict() if prof is not None else None,
                })
                if self.logger is not None:
                    self.logger.printf("%.3fs SLOW QUERY %s %s trace=%s",
                                       elapsed, index_name, short_pql,
                                       trace_id)
            if trace_tok is not None:
                tracing.current_trace_id.reset(trace_tok)

    def query(self, index_name: str, pql: str,
              shards: Optional[list[int]] = None,
              profile: bool = False, column_attrs: bool = False,
              exclude_row_attrs: bool = False,
              exclude_columns: bool = False, remote: bool = False) -> dict:
        """POST /index/{index}/query; `profile` adds the query's profile
        tree under "profile", `column_attrs` the attribute sets of the Row
        results' columns under "columnAttrSets"."""
        results = self.query_results(index_name, pql, shards=shards,
                                     profile=profile,
                                     exclude_row_attrs=exclude_row_attrs,
                                     exclude_columns=exclude_columns,
                                     remote=remote)
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

    def query_batch(self, entries: list) -> list:
        """A coordinator's coalesced envelope (POST /internal/query-batch,
        api.py:439-541): one (results, err[, profile]) per entry, in
        order. Entries run through query_results, concurrently on the
        executor's inbound pool, each under its own deadline, trace id,
        principal and priority. A write entry is refused on its own: an envelope is re-sent on
        a stale keep-alive, so it may carry reads only."""

        def one(e: dict) -> tuple:
            dl_token = tr_token = acct_token = prio_token = None
            try:
                timeout = e.get("timeout")
                if timeout is not None:
                    entry_dl = time.monotonic() + float(timeout)
                    cur = qctx.deadline.get()
                    dl_token = qctx.deadline.set(
                        entry_dl if cur is None else min(entry_dl, cur))
                if e.get("traceId"):
                    tr_token = tracing.current_trace_id.set(
                        str(e["traceId"]))
                principal = e.get("principal")
                if principal and self.usage_ledger is not None \
                        and self.usage_ledger.enabled \
                        and accounting.enabled():
                    # the entry's work is its caller's, not the leader's
                    acct_token = accounting.current_account.set(
                        accounting.Account(self.usage_ledger,
                                           accounting._sanitize(
                                               str(principal))))
                priority = e.get("priority")
                if priority and qos.enabled():
                    prio_token = qos.current_priority.set(str(priority))
                pql = e.get("query", "")
                for c in parse_string_cached(pql).calls:
                    inner = (c.children[0]
                             if c.name == "Options" and c.children else c)
                    if inner.name in WRITE_CALLS:
                        return (None, f"{inner.name}() cannot ride a "
                                      "coalesced query batch (not "
                                      "idempotent)")
                want_prof = bool(e.get("profile"))
                results = self.query_results(
                    e.get("index", ""), pql, shards=e.get("shards"),
                    remote=bool(e.get("remote", True)), profile=want_prof)
                prof = qprofile.last_profile.get() if want_prof else None
                return (results, "",
                        prof.to_dict() if prof is not None else None)
            except qctx.QueryTimeoutError as exc:
                return (None, str(exc) or "query deadline exceeded")
            except (ApiError, ValueError) as exc:
                return (None, str(exc))
            except Exception as exc:  # noqa: BLE001 — per-entry isolation
                return (None, f"{type(exc).__name__}: {exc}")
            finally:
                if dl_token is not None:
                    qctx.deadline.reset(dl_token)
                if tr_token is not None:
                    tracing.current_trace_id.reset(tr_token)
                if acct_token is not None:
                    accounting.current_account.reset(acct_token)
                if prio_token is not None:
                    qos.current_priority.reset(prio_token)

        self._validate("query")
        if len(entries) <= 1:
            return [one(e) for e in entries]
        # copied contexts: the request's trace id and deadline follow
        pool = self.executor.batch_exec_pool
        futs = [pool.submit(contextvars.copy_context().run, one, e)
                for e in entries]
        return [f.result() for f in futs]

    def explain(self, index_name: str, pql: str,
                shards: Optional[list[int]] = None) -> dict:
        """POST /index/{index}/query?explain=true: the planned tree of each
        call, executing nothing (Executor.explain_call); write calls and
        calls without a device plan say so. The calibration ring's
        aggregates ride along."""
        self._validate("query")
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
        self._validate("write")
        if self.holder.index(name) is not None:
            raise ConflictError(f"index already exists: {name}")
        try:
            idx = self.holder.create_index(name, keys=keys,
                                           track_existence=track_existence)
        except ValueError as e:
            raise ApiError(str(e))
        self._broadcast({"type": "create-index", "index": name, "keys": keys,
                         "trackExistence": track_existence})
        return idx

    def delete_index(self, name: str) -> None:
        self._validate("write")
        try:
            self.holder.delete_index(name)
        except KeyError as e:
            raise NotFoundError(str(e.args[0]))
        self.executor.clear_caches()
        self._broadcast({"type": "delete-index", "index": name})

    def create_field(self, index_name: str, field_name: str,
                     options: Optional[FieldOptions] = None):
        self._validate("write")
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        if index.field(field_name) is not None:
            raise ConflictError(f"field already exists: {field_name}")
        try:
            f = index.create_field(field_name, options)
        except ValueError as e:
            raise ApiError(str(e))
        self._broadcast({"type": "create-field", "index": index_name,
                         "field": field_name,
                         "options": dataclasses.asdict(f.options)})
        return f

    def delete_field(self, index_name: str, field_name: str) -> None:
        """DELETE /index/{i}/field/{f} (api.py:648): the field's files go,
        and the executor drops its resident leaves, cached results, heat
        entries, row forms and TopN merges."""
        self._validate("write")
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        try:
            index.delete_field(field_name)
        except KeyError as e:
            raise NotFoundError(str(e))
        self.executor.drop_field(index_name, field_name)
        self._broadcast({"type": "delete-field", "index": index_name,
                         "field": field_name})

    def schema(self) -> dict:
        self._validate("schema_read")
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

    @staticmethod
    def _forward(sends: list):
        """Start each (uri, send) on a thread of its own, in a copy of this
        context (the trace id and deadline go along); the returned wait()
        joins them and raises the first failure as a 502. The owners take
        their parts at once, while this node imports its own (api.py
        forwards one owner after another)."""
        errors: list = []

        def run(uri, send):
            try:
                send()
            except Exception as e:  # noqa: BLE001 — a 502, not a 500
                errors.append((uri, e))

        threads = [threading.Thread(target=contextvars.copy_context().run,
                                    args=(run, uri, send), daemon=True)
                   for uri, send in sends]
        for t in threads:
            t.start()

        def wait() -> None:
            for t in threads:
                t.join()
            if errors:
                uri, e = errors[0]
                raise ApiError(f"forwarding import to {uri}: {e}",
                               status=502)

        return wait

    def _route_import(self, index_name: str, field_name: str,
                      cols: np.ndarray, payload) -> tuple:
        """Split an import by shard and send each owner its part with
        remote=true (api.py:757-818): payload(sel) builds the body of the
        positions `sel`. -> (the positions this node owns, or None when
        it owns them all; wait(), to call after this node's import, which
        raises a failed send and marks the shards only other nodes own
        available here, quietly: their owners announce them)."""
        if self.forward_import_fn is None or not self._clustered():
            return None, lambda: None
        shards = cols // SHARD_WIDTH
        uniq, inverse = np.unique(shards, return_inverse=True)
        local_id = self.cluster.local_id
        by_node: dict[str, list] = {}
        local_sh = np.zeros(uniq.size, dtype=bool)
        remote_only = []
        for j, shard in enumerate(uniq.tolist()):
            owners = self._live_shard_owners(index_name, shard)
            for n in owners:
                if n.id == local_id:
                    local_sh[j] = True
                else:
                    by_node.setdefault(n.id, [n.uri, []])[1].append(j)
            if not any(n.id == local_id for n in owners):
                remote_only.append(shard)
        sends = []
        for uri, js in by_node.values():
            mask = np.zeros(uniq.size, dtype=bool)
            mask[js] = True
            body = payload(np.nonzero(mask[inverse])[0])
            sends.append((uri, lambda uri=uri, body=body:
                          self.forward_import_fn(uri, index_name,
                                                 field_name, body)))
        sent = self._forward(sends)

        def wait() -> None:
            sent()
            if remote_only:
                f = self.holder.index(index_name).field(field_name)
                f.add_available_shards(remote_only, quiet=True)

        return np.nonzero(local_sh[inverse])[0], wait

    def _live_shard_owners(self, index_name: str, shard: int) -> list:
        """A shard's owners that are not marked down; none is a 503 (an
        acknowledged import must land somewhere, api.py:746)."""
        owners = self.cluster.shard_nodes(index_name, shard)
        live = [n for n in owners if not self.cluster.is_down(n.id)]
        if owners and not live:
            raise ApiError(f"all replicas down for shard {shard}",
                           status=503)
        return live

    def import_bits(self, index_name: str, field_name: str,
                    row_ids=None, column_ids=None, clear: bool = False,
                    timestamps=None, row_keys=None,
                    column_keys=None, remote: bool = False) -> None:
        """Bulk import of (row, column) bits; marks the columns in the
        existence field unless clearing. `timestamps` (one per bit, as
        import_timestamps reads them) place a time field's bits in their
        quantum's views; other field types ignore them. Row and column
        keys, where given, are minted or looked up first (rows first, as
        api.py:688-691) and take the ids' place. In a cluster each
        shard's bits go to its owners (remote=True: this node's part)."""
        self._validate("write")
        index, f = self._field(index_name, field_name)
        if row_keys:
            row_ids = self.translate.translate_rows(index_name, field_name,
                                                    list(row_keys))
        if column_keys:
            column_ids = self.translate.translate_columns(index_name,
                                                          list(column_keys))
        if row_ids is None or column_ids is None:
            raise ApiError("import requires rows and columns")
        if (row_keys or column_keys) and None in (
                *(row_ids if row_keys else ()),
                *(column_ids if column_keys else ())):
            raise ApiError("translating import keys: no id from the "
                           "translation primary", status=503)
        rows = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        cols = np.asarray(column_ids, dtype=np.int64).reshape(-1)
        if rows.shape != cols.shape:
            raise ApiError("row/column length mismatch")
        if rows.size and (rows.min() < 0 or cols.min() < 0):
            raise ApiError("row and column ids must be non-negative")
        keep = wait = None
        if not remote:
            def payload(sel):
                body = {"rowIDs": rows[sel].tolist(),
                        "columnIDs": cols[sel].tolist(), "remote": True}
                if timestamps:
                    body["timestamps"] = [timestamps[i] for i in sel]
                if clear:
                    body["clear"] = True
                return body

            keep, wait = self._route_import(index_name, field_name, cols,
                                            payload)
            if keep is not None:
                rows, cols = rows[keep], cols[keep]
                if timestamps:
                    timestamps = [timestamps[i] for i in keep]
        try:
            if keep is None or cols.size:  # routed: only this node's part
                ts = import_timestamps(timestamps) if timestamps else None
                try:
                    f.import_bits(rows, cols, ts, clear=clear)
                except ValueError as e:
                    raise ApiError(str(e))
                if not clear:
                    # clears do not retract existence: other fields may
                    # still hold the column
                    index.mark_exists(cols)
        finally:
            if wait is not None:
                wait()

    def import_values(self, index_name: str, field_name: str,
                      column_ids=None, values=None,
                      column_keys=None, remote: bool = False) -> None:
        """Bulk import of int values (the last value of a column wins);
        marks the columns in the existence field. Column keys, where
        given, take the ids' place; in a cluster each shard's values go
        to its owners."""
        self._validate("write")
        index, f = self._field(index_name, field_name)
        if column_keys:
            column_ids = self.translate.translate_columns(index_name,
                                                          list(column_keys))
        if column_ids is None or values is None:
            raise ApiError("import requires columns and values")
        if column_keys and None in column_ids:
            raise ApiError("translating import keys: no id from the "
                           "translation primary", status=503)
        cols = np.asarray(column_ids, dtype=np.int64).reshape(-1)
        if cols.size and cols.min() < 0:
            raise ApiError("column ids must be non-negative")
        keep = wait = None
        if not remote:
            vals = np.asarray(values, dtype=np.int64).reshape(-1)
            keep, wait = self._route_import(
                index_name, field_name, cols,
                lambda sel: {"columnIDs": cols[sel].tolist(),
                             "values": vals[sel].tolist(), "remote": True})
            if keep is not None:
                cols, values = cols[keep], vals[keep]
        try:
            if keep is None or cols.size:  # routed: only this node's part
                try:
                    f.import_values(cols, values)
                except ValueError as e:
                    raise ApiError(str(e))
                index.mark_exists(cols)
        finally:
            if wait is not None:
                wait()

    def import_roaring(self, index_name: str, field_name: str, shard: int,
                       views: dict, clear: bool = False,
                       remote: bool = False) -> None:
        """POST /index/{i}/field/{f}/import-roaring/{shard} (:844-880):
        one serialized roaring bitmap of shard-local positions per view
        ("" is the standard view), unioned into (or cleared from) that
        view's fragment of the shard. Existence is not marked, as in the
        JAX package. In a cluster the bitmaps go to every owner of the
        shard, and this node imports them only if it owns it."""
        self._validate("write")
        _, f = self._field(index_name, field_name)
        if (not remote and self.forward_roaring_fn is not None
                and self._clustered()):
            owners = self._live_shard_owners(index_name, shard)
            wait = self._forward([
                (n.uri, lambda uri=n.uri: self.forward_roaring_fn(
                    uri, index_name, field_name, shard, views, clear))
                for n in owners if n.id != self.cluster.local_id])
            try:
                if any(n.id == self.cluster.local_id for n in owners):
                    self._import_roaring_local(f, shard, views, clear)
            finally:
                wait()
            if not any(n.id == self.cluster.local_id for n in owners):
                f.add_available_shards([shard], quiet=True)
            return
        self._import_roaring_local(f, shard, views, clear)

    @staticmethod
    def _import_roaring_local(f, shard: int, views: dict,
                              clear: bool) -> None:
        """The views' bitmaps unioned into (or cleared from) this node's
        fragments of the shard."""
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
        self._validate("query")
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

    # -- the cluster's internal reads ---------------------------------------

    def hosts(self) -> list:
        """GET /internal/nodes."""
        if self.cluster is None:
            return [{"id": self.node_id, "uri": self.uri,
                     "isCoordinator": True}]
        return [n.to_dict() for n in self.cluster.nodes]

    def probe_peer(self, target_uri: str) -> bool:
        """GET /internal/probe: whether target_uri answers /status."""
        if self.probe_peer_fn is None:
            return False
        try:
            return bool(self.probe_peer_fn(target_uri))
        except Exception:  # noqa: BLE001 — any failure: not alive
            return False

    def max_shards(self) -> dict:
        """GET /internal/shards/max: each index's highest shard."""
        return {name: max(idx.available_shards_list())
                for name, idx in self.holder.indexes.items()}

    def shard_nodes(self, index_name: str, shard: int) -> list:
        """GET /internal/fragment/nodes: the shard's owners."""
        if self.cluster is None:
            return self.hosts()
        return [n.to_dict()
                for n in self.cluster.shard_nodes(index_name, shard)]

    # -- membership and lifecycle (:964-1011) -------------------------------

    def set_coordinator(self, node_id: str) -> None:
        """POST /cluster/resize/set-coordinator: adopted here and by every
        peer (a later failover must not split resize coordination)."""
        self._validate("resize")
        if self.cluster is None or self.cluster.node_by_id(node_id) is None:
            raise NotFoundError(f"node not found: {node_id}")
        self.cluster.adopt_coordinator(node_id)
        self._broadcast({"type": "set-coordinator", "id": node_id})

    def remove_node(self, node_id: str):
        """POST /cluster/resize/remove-node: the coordinator's leave job
        (or, with no more nodes than replicas, a removal that degrades)."""
        self._validate("resize")
        node = (self.cluster.node_by_id(node_id)
                if self.cluster is not None else None)
        if node is None:
            raise NotFoundError(f"node not found: {node_id}")
        try:
            if self.resize_fn is not None:
                return self.resize_fn("leave", node)
            return self.cluster.node_leave(node_id)
        except ValueError as e:
            raise ApiError(str(e))

    def resize_abort(self) -> None:
        """POST /cluster/resize/abort: the coordinator cancels its job."""
        if self.cluster is None or self.cluster.state != STATE_RESIZING:
            raise ApiError("no resize job currently running")
        if self.abort_fn is not None:
            try:
                self.abort_fn()
            except ValueError as e:
                raise ApiError(str(e))
            return
        self.cluster.abort_resize()

    def drain(self, abort: bool = False) -> dict:
        """POST /cluster/drain: start this node's drain in the background
        (abort=True cancels it) and answer its status."""
        if self.drain_fn is None:
            raise ApiError("drain not supported", status=501)
        return self.drain_fn(abort=abort)

    def delete_remote_available_shard(self, index_name: str,
                                      field_name: str, shard: int) -> None:
        _, f = self._field(index_name, field_name)
        f.remove_available_shard(shard)

    # -- anti-entropy's reads (:1020-1070) ----------------------------------

    def _fragment(self, index_name: str, field_name: str, view_name: str,
                  shard: int):
        _, f = self._field(index_name, field_name)
        view = f.view(view_name)
        frag = view.fragment(shard) if view is not None else None
        if frag is None:
            raise NotFoundError("fragment not found",
                                code="fragment-not-found")
        return frag

    def fragment_blocks(self, index_name: str, field_name: str,
                        view_name: str, shard: int) -> list:
        """GET /internal/fragment/blocks: [{"id", "checksum"}]."""
        frag = self._fragment(index_name, field_name, view_name, shard)
        return [{"id": b, "checksum": chk.hex()} for b, chk in frag.blocks()]

    def fragment_block_data(self, index_name: str, field_name: str,
                            view_name: str, shard: int, block: int) -> dict:
        """GET /internal/fragment/block/data: one block's pairs."""
        frag = self._fragment(index_name, field_name, view_name, shard)
        rows, cols = frag.block_data(block)
        return {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()}

    def fragment_data(self, index_name: str, field_name: str,
                      view_name: str, shard: int) -> bytes:
        """GET /internal/fragment/data: the fragment as roaring bytes
        (what retrieve_shard streams to a rebuild)."""
        frag = self._fragment(index_name, field_name, view_name, shard)
        buf = io.BytesIO()
        frag.storage.write_to(buf)
        return buf.getvalue()

    def fragment_views(self, index_name: str, field_name: str,
                       shard: int) -> list:
        """GET /internal/fragment/views: the views holding a fragment of
        the shard (a resize follower copies each)."""
        _, f = self._field(index_name, field_name)
        return sorted(v.name for v in list(f.views.values())
                      if v.fragment(shard) is not None)

    def column_attr_diff(self, index_name: str, blocks: list,
                         block_range=None) -> dict:
        """POST /internal/index/{i}/attr/diff."""
        index = self.holder.index(index_name)
        if index is None:
            raise NotFoundError(f"index not found: {index_name}")
        return attr_diff(index.column_attrs, blocks, block_range)

    def row_attr_diff(self, index_name: str, field_name: str, blocks: list,
                      block_range=None) -> dict:
        """POST /internal/index/{i}/field/{f}/attr/diff."""
        _, f = self._field(index_name, field_name)
        return attr_diff(f.row_attrs, blocks, block_range)

    def translate_keys(self, index_name: str, field_name: Optional[str],
                       keys: list, create: bool = True) -> list:
        """POST /internal/translate/keys (the primary answers)."""
        if field_name:
            return self.translate.translate_rows(index_name, field_name,
                                                 keys, create=create)
        return self.translate.translate_columns(index_name, keys,
                                                create=create)

    def translate_data(self, offset: int = 0) -> bytes:
        """GET /internal/translate/data: the key log from `offset`."""
        return self.translate.log_bytes(offset)

    def info(self) -> dict:
        """GET /info (api.py:943): one node of one device."""
        return {"shardWidth": SHARD_WIDTH, "cpuPhysicalCores": os.cpu_count(),
                "meshDevices": 1, "version": __version__}

    def version(self) -> str:
        return __version__

    def status(self) -> dict:
        dev = self.executor.runner.device
        c = self.cluster
        return {"state": c.state if c is not None else "NORMAL",
                "nodes": self.hosts(),
                "localID": self.node_id,
                "coordinatorID": (c.coordinator_id if c is not None
                                  else self.node_id),
                # this node's own lifecycle state: a probing peer tells a
                # restarted node from a draining one by it
                "nodeState": (self.node_state_fn() if self.node_state_fn
                              is not None else "READY"),
                "uptimeSeconds": int(time.monotonic() - self.start_time),
                "version": __version__,
                "device": str(dev),
                **({"health": self._health()} if self.health_fn is not None
                   else {})}

    def _health(self) -> dict:
        try:
            return self.health_fn()
        except Exception:  # noqa: BLE001 — /status must answer regardless
            return {"score": "unknown", "reasons": []}

