"""Continuous batching of concurrent Count and Sum queries into single
launches.

Trimmed port of pilosa_tpu/parallel/batcher.py: the ContinuousBatcher
leadership protocol (:128-430) with its profile and queue-wait hooks
(:116, :339-370), without QoS and accounting; the CountBatcher (:511-565), whose dispatch launches the
pair-stream kernel (ops/kernels.py pair_stream_counts) over a batch's
distinct pairs; and the PlaneSumBatcher (:571-587, :639-660), whose
dispatch launches the bsi_sum_counts kernel once over K filters.

Leadership protocol: the first arrival for a compatibility key becomes
leader and serves exactly ONE batch, with its own request at the head.
The read batchers hand leadership to the next queued request at the cut,
before launching, so the next batch's admission overlaps this batch's
launch and result fetch; the write-side IngestBatcher (parallel/ingest.py)
holds it through its apply instead (HANDOFF_AT_CUT, :153-157, :253-312).
A short admission window gathers the resubmit burst that follows each
delivered batch. Errors wake every waiter of the failed batch.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.utils import profile as qprofile
from pilosa_tpu_torch.utils import telemetry

MAX_BATCH = 512
_FAILED = object()  # dispatch raised; error already delivered to the batch
# follower wait poll: bounds the hang if a leader thread dies without
# raising; followers re-check leader liveness and reclaim leadership
_WAIT_POLL_S = 5.0
# admission window ceiling (seconds); a lone query waits one ~0.5 ms tick
_ADMISSION_S = 0.004


class _Req:
    __slots__ = ("payload", "event", "result", "exc", "promoted", "done",
                 "server", "t_submit", "profile")

    def __init__(self, payload):
        self.payload = payload
        self.t_submit = time.perf_counter()
        # the submitter's query profile: the leader records the dispatch
        # that served this request into it
        self.profile = qprofile.current_profile.get()
        self.event = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None
        self.promoted = False  # woken to take over leadership, not served
        self.done = False  # result/exc delivered (promotion also sets event)
        # the thread serving the batch this request was cut into:
        # liveness checks consult it, not the leadership slot
        self.server: Optional[threading.Thread] = None


class ContinuousBatcher:
    """Leadership/queue machinery; subclasses implement _dispatch and
    _finalize."""

    # whether leadership passes on at the cut (before the launch) or after
    # the batch has run. At the cut suits reads: the next batch's
    # admission overlaps this one's launch and fetch. The IngestBatcher
    # holds it through the apply: group commit coalesces only if arrivals
    # pile up behind the apply in flight, and at most one batch per key is
    # applied at a time
    HANDOFF_AT_CUT = True

    # the kernel family a batch's queue wait is attributed to
    # (utils/telemetry.py KernelStats.record_wait)
    KERNEL_FAMILY = "batcher"

    def __init__(self, max_batch: int = MAX_BATCH,
                 admission_s: float = _ADMISSION_S):
        self.max_batch = max_batch
        self.admission_s = admission_s
        self._lock = threading.Lock()
        self._pending: dict[tuple, list[_Req]] = defaultdict(list)
        self._leaders: set[tuple] = set()
        self._leader_threads: dict[tuple, threading.Thread] = {}
        self.batches = 0
        self.batched_queries = 0
        self.max_batch_seen = 0
        self.wait_ms_total = 0.0
        self.waited = 0

    def submit(self, key: tuple, payload):
        """Enqueue one query under compatibility `key`; blocks until a
        batch containing it ran; returns its result."""
        req = _Req(payload)
        with self._lock:
            self._pending[key].append(req)
            lead = key not in self._leaders
            if lead:
                self._leaders.add(key)
                self._leader_threads[key] = threading.current_thread()
        if not lead:
            while not req.event.wait(_WAIT_POLL_S):
                with self._lock:
                    if req.done:
                        break
                    if req in self._pending.get(key, ()):
                        t = self._leader_threads.get(key)
                        if t is not None and t.is_alive():
                            continue  # leader healthy
                        # dead leader, our request still queued: take over
                        self._leaders.add(key)
                        self._leader_threads[key] = threading.current_thread()
                        req.promoted = True
                        req.event.set()
                    else:
                        t = req.server
                        if t is not None and t.is_alive():
                            continue  # finalize in flight
                        req.exc = RuntimeError("batch leader died mid-compute")
                        req.event.set()
            if not req.promoted:
                if req.exc is not None:
                    raise req.exc
                return req.result
        self._serve_one_batch(key)
        # usually our own request was the queue head; keep serving while it
        # is queued, poll while it is in another leader's in-flight batch
        while not req.done:
            with self._lock:
                in_q = req in self._pending.get(key, ())
            if in_q:
                self._serve_one_batch(key)
                continue
            time.sleep(0.002)
            if req.done:
                break
            with self._lock:
                t = req.server if req.server is not None \
                    else self._leader_threads.get(key)
                if (t is None or not t.is_alive()) and not req.done:
                    req.exc = RuntimeError("batch leader died mid-compute")
                    break
        if req.exc is not None:
            raise req.exc
        return req.result

    def _serve_one_batch(self, key: tuple) -> None:
        with self._lock:
            self._leader_threads[key] = threading.current_thread()
        # wait out the resubmit burst until an arrival lull (one tick
        # without growth), so it lands in one launch
        if self.admission_s > 0:
            deadline = time.perf_counter() + self.admission_s
            last = -1
            while True:
                with self._lock:
                    n = len(self._pending.get(key, ()))
                if (n >= self.max_batch or n == last
                        or time.perf_counter() >= deadline):
                    break
                last = n
                time.sleep(0.0005)
        with self._lock:
            q = self._pending[key]
            batch, q[:] = q[:self.max_batch], q[self.max_batch:]
            for r in batch:
                r.server = threading.current_thread()
            if self.HANDOFF_AT_CUT:
                # leadership hands off here, before the launch
                self._hand_off_locked(key)
        t_cut = time.perf_counter()
        try:
            if not batch:
                return
            handle = _FAILED
            try:
                handle = self._dispatch(key, [r.payload for r in batch])
            except BaseException as e:  # noqa: BLE001 — every waiter wakes
                self._deliver_exc(batch, e)
            if handle is not _FAILED:
                self._run(key, batch, handle, t_cut)
        finally:
            if not self.HANDOFF_AT_CUT:
                # after the apply, on every exit path: this thread stays
                # leader through it and returns alive, so the followers'
                # dead-leader reclaim never fires for it
                with self._lock:
                    self._hand_off_locked(key)

    def _hand_off_locked(self, key: tuple) -> None:
        """Promote the next queued request to leader, or release the key
        when its queue is empty. Called with self._lock held."""
        q = self._pending.get(key)
        if q:
            q[0].promoted = True
            q[0].event.set()
        else:
            self._leaders.discard(key)
            self._leader_threads.pop(key, None)
            self._pending.pop(key, None)

    def _run(self, key: tuple, batch: list[_Req], handle,
             t_cut: float) -> None:
        try:
            results = self._finalize(key, handle, [r.payload for r in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batcher returned {len(results)} results for "
                    f"{len(batch)} payloads")
            t_done = time.perf_counter()
            batch_wait_ms = sum((t_done - r.t_submit) * 1e3 for r in batch)
            with self._lock:
                self.batches += 1
                self.batched_queries += len(batch)
                self.max_batch_seen = max(self.max_batch_seen, len(batch))
                self.wait_ms_total += batch_wait_ms
                self.waited += len(batch)
                seq = self.batches
            if telemetry.kernel_stats_enabled():
                telemetry.kernels.record_wait(self.KERNEL_FAMILY,
                                              batch_wait_ms, len(batch))
            wall_ms = (t_done - t_cut) * 1e3
            kind = type(self).__name__
            for r in batch:
                # every profiled co-batched query learns the dispatch that
                # served it, the batch size and its wall-time share
                if r.profile is not None:
                    r.profile.record_dispatch(kind, seq, len(batch), wall_ms)
            for r, res in zip(batch, results):
                r.result = res
                r.done = True
                r.event.set()
        except BaseException as e:  # noqa: BLE001 — every waiter must wake
            self._deliver_exc(batch, e)

    @staticmethod
    def _deliver_exc(batch: list[_Req], e: BaseException) -> None:
        for r in batch:
            r.exc = e
            r.done = True
            r.event.set()

    def _dispatch(self, key: tuple, payloads: list):
        raise NotImplementedError

    def _finalize(self, key: tuple, handle, payloads: list) -> list:
        raise NotImplementedError

    def snapshot(self) -> dict:
        """The JAX batcher's snapshot keys (:418), which /debug/vars and
        /metrics read."""
        with self._lock:
            return {"batches": self.batches,
                    "batched_queries": self.batched_queries,
                    "max_batch_seen": self.max_batch_seen,
                    "queue_depth": sum(len(q) for q in self._pending.values()),
                    "wait_ms_total": round(self.wait_ms_total, 3),
                    "waited": self.waited,
                    "avg_wait_ms": round(self.wait_ms_total / self.waited, 3)
                    if self.waited else 0.0}


class CountBatcher(ContinuousBatcher):
    """Batches Count over 1- and 2-leaf programs into one pair-stream
    launch. Compatibility key = (op, leaf shape, dtype, device). A batch is
    launched over its distinct canonical pairs (ops/kernels.py plan_pairs:
    concurrent clients asking about the same rows are counted once)."""

    def count(self, op: str, a: torch.Tensor,
              b: Optional[torch.Tensor]) -> int:
        if b is None:
            op, b = "id", a
        return self.submit((op, tuple(a.shape), str(a.dtype), str(a.device)),
                           (a, b))

    def _dispatch(self, key: tuple, payloads: list):
        slots: dict[int, int] = {}
        leaves: list = []

        def slot(t) -> int:
            s = slots.get(id(t))
            if s is None:
                s = slots[id(t)] = len(leaves)
                leaves.append(t)
            return s

        plan = kernels.plan_pairs([slot(a) for a, _ in payloads],
                                  [slot(b) for _, b in payloads], key[0])
        # launched, not fetched: the int32[P, C] partials stay on the
        # device until _finalize
        return (kernels.pair_stream_counts(leaves, plan.a, plan.b, key[0]),
                plan.inverse)

    def _finalize(self, key: tuple, handle, payloads: list) -> list:
        parts, inverse = handle
        # the batch's one device->host fetch; exact int64 finish
        counts = parts.cpu().numpy().astype(np.int64).sum(axis=-1)
        return counts[inverse].tolist()


class PlaneSumBatcher(ContinuousBatcher):
    """Batches BSI Sums that share a resident plane slab (same field,
    shard set and generations): concurrent Sum(Range(v > x)) with varying
    thresholds coalesce into one bsi_sum_counts launch over a device table
    of K filter pointers. Compatibility key = identity of the slab.
    Identical filter tensors (every unfiltered Sum passes the resident
    not-null row) are counted once."""

    def plane_sums(self, planes: torch.Tensor,
                   mask: torch.Tensor) -> np.ndarray:
        """int64[D + 1] totals: per-plane popcount(planes & mask), then the
        mask's own count."""
        return self.submit((id(planes), tuple(planes.shape),
                            str(planes.device)), (planes, mask))

    def _dispatch(self, key: tuple, payloads: list):
        slots: dict[int, int] = {}
        masks: list = []
        idx = []
        for _, m in payloads:
            s = slots.get(id(m))
            if s is None:
                s = slots[id(m)] = len(masks)
                masks.append(m)
            idx.append(s)
        # launched, not fetched: int32[K, D+1, S] stays on the device
        return kernels.bsi_sum_counts(payloads[0][0], masks), idx

    def _finalize(self, key: tuple, handle, payloads: list) -> list:
        counts, idx = handle
        # the batch's one device->host fetch; exact int64 finish over shards
        totals = counts.cpu().numpy().astype(np.int64).sum(axis=-1)
        return [totals[i] for i in idx]
