"""Network coalescing: concurrent fan-out reads to one node share one RPC.

Trimmed port of pilosa_tpu/net/coalesce.py: NodeCoalescer (:53) on the
port's ContinuousBatcher (parallel/batcher.py). Concurrent reads that a
coordinator sends to the same node queue under that node's URI; the first
arrival leads, waits out the admission window (the coalesce window),
cuts the batch at max_batch and sends it as one POST /internal/query-batch
envelope of (index, pql, shards) entries. At most max_inflight envelopes
per node are on the wire at a time, so envelopes grow with the arrival
rate instead of leaving one or two queries each. The remote node runs the
entries concurrently, so its CountBatcher and PlaneSumBatcher coalesce
them in turn.

Identical entries of one envelope go on the wire once (single-flight)
and are decoded once per waiter, since the executor changes the results
it is given. An entry's error fails only its waiters. A node that answers
the route with 404 (one that predates it) is marked legacy for
legacy_ttl seconds: every waiter of that envelope, and every later query
to it until the mark expires, goes per query through query_proto.

Reads only: the executor sends writes through query_proto, since an
envelope is re-sent once on a stale keep-alive. PILOSA_TPU_TORCH_NET_COALESCE=0
(the JAX package's PILOSA_TPU_NET_COALESCE) turns the coalescer off when the
executor is built; `enabled` switches it at run time.

Each entry carries its caller's principal and QoS priority (:112-136,
:181-221), so the remote node charges and orders the entry as its
caller's; a duplicate runs at the most urgent priority among its callers.
Each waiter's account pays its entry's response bytes (rpc_bytes), and no
device ms (ACCOUNT_DEVICE_MS: an envelope is wire time).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from pilosa_tpu_torch import qos
from pilosa_tpu_torch.net.client import ClientError
from pilosa_tpu_torch.parallel.batcher import ContinuousBatcher
from pilosa_tpu_torch.utils import accounting
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import qctx, tracing

# per-waiter sentinel: the node 404'd the route; re-issue per query
_FALLBACK = object()


class NodeCoalescer(ContinuousBatcher):
    """Coalesces concurrent read-only fan-out queries per destination URI
    (compatibility key (uri,))."""

    # an envelope is not a device dispatch
    KERNEL_FAMILY = None
    ACCOUNT_DEVICE_MS = False

    def __init__(self, client, window_s: float = 0.002, max_batch: int = 64,
                 legacy_ttl: float = 300.0, max_inflight: int = 2):
        super().__init__(max_batch=max_batch, admission_s=window_s)
        self.client = client
        self.enabled = True
        self.legacy_ttl = legacy_ttl
        self.max_inflight = max_inflight
        self._legacy: dict[str, float] = {}  # uri -> monotonic mark time
        self._meta_lock = threading.Lock()
        self._sems: dict[tuple, threading.BoundedSemaphore] = {}
        self.size_hist: dict[int, int] = {}  # netCoalesceBatchSize
        self.fallback_queries = 0  # entries served per query after a 404
        self.deduped_queries = 0  # wire entries saved by single-flight
        # 404'd envelopes still count as served batches in the base
        # class; snapshot() takes them out of the coalesce factor
        self._fb_batches = 0
        self._fb_queries = 0

    # -- public -------------------------------------------------------------

    def query(self, uri: str, index: str, pql: str,
              shards: Optional[list] = None) -> list:
        """One read-only remote query; its decoded results. Each entry
        carries its caller's remaining deadline, trace id, principal and
        priority."""
        rem = qctx.remaining()
        if rem is not None and rem <= 0:
            raise qctx.QueryTimeoutError("query deadline exceeded")
        if not self.enabled or self._is_legacy(uri):
            return self.client.query_proto(uri, index, pql, shards=shards,
                                           remote=True)
        prof = qprofile.current_profile.get()
        acct = accounting.current_account.get()
        out = self.submit((uri,), (index, pql, shards, rem,
                                   tracing.current_trace_id.get(),
                                   prof is not None,
                                   acct.principal if acct is not None
                                   else None,
                                   qos.current_priority.get()))
        if out is _FALLBACK:
            with self._meta_lock:
                self.fallback_queries += 1
            return self.client.query_proto(uri, index, pql, shards=shards,
                                           remote=True)
        if isinstance(out, ClientError):
            raise out  # this entry's remote error
        results, fragment, nbytes = out
        # on the waiter's thread: the leader serves other queries
        if prof is not None and fragment:
            prof.add_remote_fragment(uri, fragment)
        if acct is not None and nbytes:
            acct.charge(rpc_bytes=nbytes)
        return results

    # -- the in-flight window ----------------------------------------------

    def _sem_for(self, key: tuple) -> threading.BoundedSemaphore:
        with self._meta_lock:
            sem = self._sems.get(key)
            if sem is None:
                sem = self._sems[key] = threading.BoundedSemaphore(
                    max(1, self.max_inflight))
            return sem

    def _serve_one_batch(self, key: tuple) -> None:
        # a would-be leader waits for a send slot while its queue grows
        sem = self._sem_for(key)
        sem.acquire()
        try:
            super()._serve_one_batch(key)
        finally:
            sem.release()

    # -- the batch (on the leader's thread) --------------------------------

    def _dispatch(self, key: tuple, payloads: list) -> list:
        uri = key[0]
        # single-flight: identical (index, pql, shards) entries share one
        # wire entry; a duplicate keeps the loosest deadline
        slots: list[int] = []
        uniq: dict[tuple, int] = {}
        entries: list[dict] = []
        for (i, q, s, rem, trace_id, want_prof, principal,
             priority) in payloads:
            k = (i, q, tuple(s) if s is not None else None)
            at = uniq.get(k)
            if at is None:
                at = uniq[k] = len(entries)
                entry = {"index": i, "query": q, "shards": s,
                         "remote": True}
                if rem is not None:
                    entry["timeout"] = round(rem, 3)
                if trace_id:
                    entry["traceId"] = trace_id
                if principal:
                    entry["principal"] = principal
                if priority:
                    entry["priority"] = priority
                if want_prof:
                    entry["profile"] = True
                entries.append(entry)
            else:
                if rem is not None and "timeout" in entries[at]:
                    entries[at]["timeout"] = max(entries[at]["timeout"],
                                                 round(rem, 3))
                elif "timeout" in entries[at]:
                    del entries[at]["timeout"]  # a caller without one
                if want_prof:
                    entries[at]["profile"] = True
                if priority and qos.priority_level(priority) < \
                        qos.priority_level(entries[at].get("priority")):
                    entries[at]["priority"] = priority
            slots.append(at)
        # the envelope is sent under its loosest deadline, not the
        # leader's: each entry still carries its own
        rems = [p[3] for p in payloads]
        env_dl = (None if any(r is None for r in rems)
                  else time.monotonic() + max(rems))
        dl_token = qctx.deadline.set(env_dl)
        try:
            raw = self.client.query_batch_raw(uri, entries)
        except ClientError as e:
            if e.status == 404:
                with self._meta_lock:
                    self._legacy[uri] = time.monotonic()
                    self._fb_batches += 1
                    self._fb_queries += len(payloads)
                return [_FALLBACK] * len(payloads)
            raise  # every waiter fails over per shard
        finally:
            qctx.deadline.reset(dl_token)
        if len(raw) != len(entries):
            raise ClientError(f"query-batch: {len(raw)} responses for "
                              f"{len(entries)} entries")
        with self._meta_lock:
            n = len(payloads)
            self.size_hist[n] = self.size_hist.get(n, 0) + 1
            self.deduped_queries += len(payloads) - len(entries)
        from pilosa_tpu_torch.encoding.protobuf import Serializer
        ser = Serializer()
        out = []
        for at in slots:  # decoded per waiter
            try:
                resp = ser.decode_query_response(raw[at])
            except Exception as e:  # noqa: BLE001 — fails its waiters only
                out.append(ClientError(f"query-batch: undecodable entry: "
                                       f"{type(e).__name__}: {e}"))
                continue
            if resp["err"]:
                out.append(ClientError(f"remote query: {resp['err']}"))
            else:
                out.append((resp["results"], resp.get("profile"),
                            len(raw[at])))
        return out

    def _finalize(self, key: tuple, handle, payloads: list) -> list:
        return handle

    # -- legacy nodes -------------------------------------------------------

    def _is_legacy(self, uri: str) -> bool:
        with self._meta_lock:
            t = self._legacy.get(uri)
            if t is None:
                return False
            if time.monotonic() - t > self.legacy_ttl:
                del self._legacy[uri]  # re-probe with the next envelope
                return False
            return True

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        out = super().snapshot()
        with self._meta_lock:
            out["batches"] = max(0, out["batches"] - self._fb_batches)
            out["batched_queries"] = max(
                0, out["batched_queries"] - self._fb_queries)
            out["netCoalesceBatchSize"] = {
                str(k): v for k, v in sorted(self.size_hist.items())}
            out["fallback_queries"] = self.fallback_queries
            out["deduped_queries"] = self.deduped_queries
            out["legacy_nodes"] = len(self._legacy)
        out["enabled"] = self.enabled
        out["mean_coalesce_factor"] = (
            round(out["batched_queries"] / out["batches"], 3)
            if out["batches"] else 0.0)
        return out
