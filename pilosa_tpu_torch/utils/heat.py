"""Fragment heat map: per-(index, field, view, shard) data temperature.

Port of pilosa_tpu/utils/heat.py: HeatTracker (:165) keeps, per fragment,
read and write counts decayed with three half-lives (1 min, 10 min,
1 h), cumulative charges (FIELDS), and the last read and write times.
The score is the sum of the decayed counts over their half-lives; a
fragment is hot at HOT_SCORE. At `max_fragments` the coldest entry spills
into the `~other` totals (lowest score first, ties to the smaller key), so
totals stay exact. Charge sites: the executor's row-leaf reads, the write
path, and the residency's uploads and evictions; `eviction = "heat"` and
the hybrid chooser's cold demotion read the scores.

The store is the port's own. The JAX tracker keeps one dict per fragment
and decays each in a Python loop; a port leaf covers 1024 shards, and
every leaf read charges all of them, which would cost milliseconds of
GIL-held Python per query. Here each (index, field, view) holds numpy
arrays indexed by a sorted shard array, so charging a shard set (Frags)
is a handful of vectorised operations. A charge that would pass
max_fragments spills over the same arrays: the tracked entries sorted
once by (score, key), and where a spilled entry is not simply one of
the coldest, the JAX tracker's turn-by-turn order over a heap of the
charge's keys. Scores, counters, spills and snapshots equal the JAX
tracker's at the same `now` (tests/test_torch_obs.py). A request thread
only queues its charge: the queue is applied in order, each charge at
its own `now`, before every read and at the telemetry sampler's tick, so
32 request threads never wait on the tracker's lock.

PILOSA_TPU_TORCH_HEAT=0 (the JAX package's PILOSA_TPU_HEAT) builds no
tracker: every charge site is one None check and eviction stays LRU.

merge_heat_docs (:390) merges the nodes' documents into the fleet's
(GET /cluster/heat).
"""

from __future__ import annotations

import collections
import heapq
import math
import os
import sys
import threading
import time
from typing import NamedTuple, Optional

import numpy as np

# the spill bucket: charges of fragments beyond the table bound
SPILL = "~other"

# decay half-lives (seconds): the short one ranks eviction, the long ones
# what stays warm
HALF_LIVES = (60.0, 600.0, 3600.0)

# cumulative per-fragment charge fields
FIELDS = ("reads", "writes", "deviceMs", "h2dBytes", "uploads",
          "evictions")

# a fragment is hot at this score: one access within the 10 min half-life
# qualifies, an hour idle does not
HOT_SCORE = 1e-3

# bounds of the score distribution (log decades, 7 labels)
DISTRIBUTION_BOUNDS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

# the BSI leaf kinds carry no view name in their residency keys: their
# fragments are the field's bsig_<field> view (models/field.py)
_BSI_VIEW_PREFIX = "bsig_"

_N = len(HALF_LIVES)

# pending charges at which the charging thread applies them itself (the
# sampler's tick applies them every interval)
PENDING_MAX = 8192


def enabled() -> bool:
    """PILOSA_TPU_TORCH_HEAT=0 builds no tracker and forces residency
    eviction back to lru (read at Executor construction and per eviction
    pass)."""
    return os.environ.get("PILOSA_TPU_TORCH_HEAT", "1") != "0"


class Frags(NamedTuple):
    """The fragments of one leaf: one (index, field, view) over a shard
    set, the compact form of [(index, field, view, s) for s in shards]."""

    index: str
    field: str
    view: str
    shards: tuple

    def keys(self) -> list:
        return [(self.index, self.field, self.view, int(s))
                for s in self.shards]


def leaf_frags(key) -> list:
    """The Frags a residency leaf key covers (the attribution bridge
    between version-keyed leaves and the fragment table, JAX :126-162).
    Synthetic leaves ("zeros") and unknown kinds cover none."""
    if not isinstance(key, tuple) or not key:
        return []
    kind = key[0]
    if kind == "row" and len(key) >= 7:
        return [Frags(key[1], key[2], key[3], key[5])]
    if kind in ("sparse", "run") and len(key) >= 8:
        return [Frags(key[1], key[2], key[3], key[5])]
    if kind == "timerange" and len(key) >= 7:
        return [Frags(key[1], key[2], v, key[5]) for v in key[4]]
    if kind == "bsicmp" and len(key) >= 8:
        return [Frags(key[1], key[2], _BSI_VIEW_PREFIX + key[2], key[6])]
    if kind == "bsiplanes" and len(key) >= 6:
        return [Frags(key[1], key[2], _BSI_VIEW_PREFIX + key[2], key[4])]
    if kind == "rows_slab" and len(key) >= 7:
        return [Frags(key[1], key[2], key[3], key[4])]
    return []


def leaf_frag_keys(key) -> list:
    """leaf_frags(key) as the JAX package's list of (index, field, view,
    shard) tuples."""
    return [k for fr in leaf_frags(key) for k in fr.keys()]


# -- the store: one set of arrays per (index, field, view) -------------------


def _scores(ewma: np.ndarray) -> np.ndarray:
    """The JAX _score of each column of a (2 * len(HALF_LIVES), k) EWMA
    array (reads, then writes), elementwise as Python's sum() adds the
    per-half-life terms: with Neumaier compensation from 3.12 on."""
    terms = [(ewma[i] + ewma[_N + i]) / HALF_LIVES[i] for i in range(_N)]
    total = terms[0]
    if sys.version_info < (3, 12):
        for x in terms[1:]:
            total = total + x
        return total
    comp = np.zeros_like(total)
    for x in terms[1:]:
        t = total + x
        comp += np.where(np.abs(total) >= np.abs(x), (total - t) + x,
                         (x - t) + total)
        total = t
    return total + comp


def _charge(ewma, acc, last, reads, writes, share_ms: float,
            share_bytes: float, uploads, evictions, now: float) -> None:
    """The JAX tracker's charge of each column (decayed to `now`), in
    place. `writes` is a count or an array of one per column."""
    if reads:
        ewma[:_N] += reads
        acc[0] += reads
        last[0] = now
    if np.isscalar(writes):
        if writes:
            ewma[_N:] += writes
            acc[1] += writes
            last[1] = now
    else:
        w = np.asarray(writes, dtype=np.float64)
        ewma[_N:] += w
        acc[1] += w
        last[1, w != 0] = now
    # zero charges are skipped: the sums start at +0.0 and only grow
    for row, v in ((2, share_ms), (3, share_bytes), (4, uploads),
                   (5, evictions)):
        if v:
            acc[row] += v


def _contiguous(slots: np.ndarray):
    """A slice for strictly increasing slots without gaps (views, not
    gathers), else the array."""
    if slots.size and int(slots[-1]) - int(slots[0]) == slots.size - 1:
        return slice(int(slots[0]), int(slots[-1]) + 1)
    return slots


class _Group:
    """The fragments of one (index, field, view): column j is shard
    shards[j] (sorted). ewma rows 0..2 are the read counts per half-life,
    rows 3..5 the write counts; acc rows follow FIELDS; last rows are the
    last read and write times (NaN: never)."""

    __slots__ = ("shards", "ewma", "t", "acc", "last", "memo")

    def __init__(self):
        self.shards = np.empty(0, dtype=np.int64)
        self.ewma = np.empty((2 * _N, 0))
        self.t = np.empty(0)
        self.acc = np.empty((len(FIELDS), 0))
        self.last = np.empty((2, 0))
        self.memo = None  # (shards tuple, slots): the last Frags located

    def locate(self, shards) -> tuple:
        """(int64 shards, slots, found) of a shard tuple: found is None
        when every shard is tracked, else the mask of those that are.
        Raises ValueError for a tuple that is not strictly increasing."""
        memo = self.memo
        if memo is not None and memo[0] == shards:
            return memo[1], memo[2], None
        arr = np.fromiter(shards, dtype=np.int64, count=len(shards))
        if arr.size > 1 and not (arr[1:] > arr[:-1]).all():
            raise ValueError("shards are not strictly increasing")
        n = self.shards.size
        slots = np.searchsorted(self.shards, arr)
        if n:
            found = (slots < n) & (self.shards[np.minimum(slots, n - 1)]
                                   == arr)
        else:
            found = np.zeros(arr.size, dtype=bool)
        if found.all():
            slots = _contiguous(slots)
            self.memo = (shards, arr, slots)
            return arr, slots, None
        return arr, slots, found

    def insert(self, new: np.ndarray, now, ewma=None, acc=None,
               last=None) -> None:
        """Add untracked shards (sorted, unique): fresh entries at `now`
        (a time, or one per shard), or the given columns."""
        pos = np.searchsorted(self.shards, new)
        k = new.size
        self.shards = np.insert(self.shards, pos, new)
        self.ewma = np.insert(self.ewma, pos, np.zeros((2 * _N, k))
                              if ewma is None else ewma, axis=1)
        self.t = np.insert(self.t, pos, np.broadcast_to(now, (k,)))
        self.acc = np.insert(self.acc, pos, np.zeros((len(FIELDS), k))
                             if acc is None else acc, axis=1)
        self.last = np.insert(self.last, pos, np.full((2, k), np.nan)
                              if last is None else last, axis=1)
        self.memo = None

    def delete(self, slots) -> None:
        self.shards = np.delete(self.shards, slots)
        self.ewma = np.delete(self.ewma, slots, axis=1)
        self.t = np.delete(self.t, slots)
        self.acc = np.delete(self.acc, slots, axis=1)
        self.last = np.delete(self.last, slots, axis=1)
        self.memo = None

    def decay(self, slots, now: float) -> None:
        """Decay the entries at `slots` (None: all) to `now` (JAX _decay,
        per entry: the factors come from Python's pow on each distinct
        dt)."""
        if slots is None:
            slots = slice(0, self.t.size)
        dt = now - self.t[slots]
        if not dt.size:
            return
        lo, hi = dt.min(), dt.max()
        if hi <= 0:
            return
        if lo == hi:
            d = float(lo)
            f = np.array([0.5 ** (d / hl) for hl in HALF_LIVES] * 2)
            self.ewma[:, slots] *= f[:, None]
            self.t[slots] = now
            return
        pos = dt > 0
        uniq, inv = np.unique(dt[pos], return_inverse=True)
        f = np.array([[0.5 ** (float(d) / hl) for d in uniq]
                      for hl in HALF_LIVES])
        s = np.arange(self.t.size)[slots][pos]
        self.ewma[:, s] *= np.concatenate([f, f])[:, inv]
        self.t[s] = now

    def scores(self, slots=None) -> np.ndarray:
        return _scores(self.ewma if slots is None else self.ewma[:, slots])


class HeatTracker:
    """Bounded per-fragment temperature table plus a since-cursor ring of
    aggregate summaries (GET /debug/heat?since=)."""

    def __init__(self, max_fragments: int = 4096, ring_size: int = 360):
        self.enabled = True  # runtime toggle; the env switch is read at
        # Executor construction (no tracker is built)
        self.max_fragments = max(2, int(max_fragments))
        self._lock = threading.Lock()
        # charges not yet applied, in call order: a serving thread only
        # appends (no lock: 32 threads on one lock queue up behind it);
        # every read applies them first, in order and at their own `now`,
        # so what any read sees is what charging at once would give
        self._pending: collections.deque = collections.deque()
        self._groups: dict[tuple, _Group] = {}
        self._count = 0
        self._other = dict.fromkeys(FIELDS, 0.0)  # the SPILL aggregate
        self.spilled_fragments = 0
        # imported here: the advisor's command line reads HOT_SCORE and
        # merge_heat_docs without loading torch (telemetry's import)
        from pilosa_tpu_torch.utils.telemetry import Ring

        self.ring = Ring(ring_size)

    # -- charging ------------------------------------------------------------

    def touch(self, index: str, field: str, view: str, shard: int,
              reads: int = 0, writes: int = 0, device_ms: float = 0.0,
              h2d_bytes: int = 0, uploads: int = 0, evictions: int = 0,
              now: Optional[float] = None) -> None:
        self.touch_many(Frags(index, field, view, (int(shard),)),
                        reads=reads, writes=writes, device_ms=device_ms,
                        h2d_bytes=h2d_bytes, uploads=uploads,
                        evictions=evictions, now=now)

    def touch_many(self, keys, reads: int = 0, writes=0,
                   device_ms: float = 0.0, h2d_bytes: int = 0,
                   uploads: int = 0, evictions: int = 0,
                   now: Optional[float] = None) -> None:
        """Charge every key. `keys` is a Frags or a list of (index, field,
        view, shard) tuples; with a Frags, `writes` may be an int array
        giving each shard its count. device_ms and h2d_bytes are totals
        split evenly over the keys. The charge is queued and applied
        before the next read."""
        n = len(keys.shards) if isinstance(keys, Frags) else len(keys)
        if not self.enabled or not n:
            return
        if now is None:
            now = time.monotonic()
        self._pending.append((keys, reads, writes, device_ms / n,
                              h2d_bytes / n, uploads, evictions, now))
        if len(self._pending) > PENDING_MAX:
            with self._lock:
                self._drain_locked()

    def flush(self) -> None:
        """Apply the queued charges now (every read does it first)."""
        with self._lock:
            self._drain_locked()

    def _drain_locked(self) -> None:
        pending = self._pending
        while pending:
            self._apply_locked(*pending.popleft())

    def _apply_locked(self, keys, reads, writes, share_ms: float,
                      share_bytes: float, uploads, evictions,
                      now: float) -> None:
        """The JAX tracker's touch_many (:197-233) charges key by key; a
        strictly increasing run of one (index, field, view) is charged
        here as one shard set, with the same result (a list of keys goes
        as its runs, in order)."""
        rest = (share_ms, share_bytes, uploads, evictions, now)
        if isinstance(keys, Frags):
            self._touch_frags(keys[:3], keys.shards, reads, writes, *rest)
            return
        a = 0
        for b in range(1, len(keys) + 1):
            if b == len(keys) or keys[b][:3] != keys[a][:3]:
                self._touch_frags(tuple(keys[a][:3]),
                                  tuple(int(k[3]) for k in keys[a:b]),
                                  reads, writes, *rest)
                a = b

    def _touch_frags(self, gkey: tuple, shards: tuple, reads, writes,
                     share_ms: float, share_bytes: float, uploads,
                     evictions, now: float) -> None:
        """The charge of one shard set of gkey, in increasing runs."""
        g = self._groups.get(gkey)
        fresh = g is None
        if fresh:
            g = _Group()
        try:
            arr, slots, found = g.locate(shards)
        except ValueError:
            arr = np.asarray(shards, dtype=np.int64)
            cuts = (np.flatnonzero(arr[1:] <= arr[:-1]) + 1).tolist()
            for a, b in zip([0, *cuts], [*cuts, arr.size]):
                w = writes if np.isscalar(writes) else writes[a:b]
                self._touch_frags(gkey, tuple(shards[a:b]), reads, w,
                                  share_ms, share_bytes, uploads, evictions,
                                  now)
            return
        charge = (reads, writes, share_ms, share_bytes, uploads, evictions,
                  now)
        if found is not None:
            new = arr[~found]
            if self._count + new.size > self.max_fragments:
                self._spill_charge(gkey, g, arr, found, charge)
                return
            if fresh:
                self._groups[gkey] = g
            g.insert(new, now)
            self._count += new.size
            slots = _contiguous(np.searchsorted(g.shards, arr))
        g.decay(slots, now)
        cols = (g.ewma[:, slots], g.acc[:, slots], g.last[:, slots])
        _charge(*cols, *charge)
        if not isinstance(slots, slice):  # gathers, not views
            g.ewma[:, slots], g.acc[:, slots], g.last[:, slots] = cols

    def _spill_charge(self, gkey: tuple, g: _Group, arr: np.ndarray,
                      found: np.ndarray, charge: tuple) -> None:
        """A charge of the shards `arr` of gkey (`found`: those tracked)
        that passes max_fragments, with the JAX result: key by key in
        shard order, a key not tracked at its turn first spills the entry
        lowest by (score, key) while the table is full, every entry
        decayed to `now`. The candidates are the tracked entries at their
        scores before the charge (sorted once) and the charge's keys at
        their scores after it (a heap); where every victim is colder than
        all of the charge's keys, the victims are the first of the sorted
        entries, and no key needs a turn of its own."""
        now = charge[-1]
        groups = self._groups
        for h in groups.values():
            h.decay(None, now)
        glist = list(groups.items())
        rank = {k: i for i, k in enumerate(sorted({*groups, gkey}))}
        sizes = [h.shards.size for _, h in glist]
        base = np.cumsum([0, *sizes])
        sc = np.concatenate([h.scores() for _, h in glist] or [[]])
        gr = np.repeat([rank[k] for k, _ in glist], sizes)
        sh = np.concatenate([h.shards for _, h in glist] or [[]])
        order = np.lexsort((sh, gr, sc))
        where = np.empty(order.size, dtype=np.int64)
        where[order] = np.arange(order.size)

        # the charge's columns after it: tracked ones from their decayed
        # state, the others (and any spilled before its turn) from zero
        n, k = arr.size, len(FIELDS)
        col = np.searchsorted(g.shards, arr)
        post = (np.zeros((2 * _N, n)), np.zeros((k, n)),
                np.full((2, n), np.nan))
        zero = (np.zeros((2 * _N, n)), np.zeros((k, n)),
                np.full((2, n), np.nan))
        t = np.full(n, now)  # a decay to an earlier `now` keeps t
        if found.any():
            c = col[found]
            post[0][:, found] = g.ewma[:, c]
            post[1][:, found] = g.acc[:, c]
            post[2][:, found] = g.last[:, c]
            t[found] = g.t[c]
        _charge(*post, *charge)
        _charge(*zero, *charge)
        b, f = _scores(post[0]), _scores(zero[0])
        pos = np.full(n, -1, dtype=np.int64)  # sorted position, if tracked
        gi = next((i for i, (key, _) in enumerate(glist) if key == gkey),
                  None)
        if gi is not None:
            pos[found] = where[base[gi] + col[found]]

        kind, at = self._spill_order(order.size, pos, sc[order], gr[order],
                                     sh[order], b, f, rank[gkey], arr,
                                     np.isscalar(charge[1]))
        # the spilled entries' totals, in spill order (as the JAX tracker
        # adds them)
        acc = np.concatenate([h.acc for _, h in glist] + [post[1], zero[1]],
                             axis=1)
        src = base[-1] + at + np.where(kind == 2, n, 0)
        src[kind == 0] = order[at[kind == 0]]
        spilled = acc[:, src]
        for i, fld in enumerate(FIELDS):
            self._other[fld] = float(np.add.accumulate(
                np.concatenate(([self._other[fld]], spilled[i])))[-1])
        self.spilled_fragments += int(kind.size)

        # the charge's keys end as charged from their state (1), from
        # zero (2), or spilled (0)
        state = np.where(found, 1, 2)
        tracked = np.flatnonzero(found)
        state[tracked[np.isin(pos[tracked], at[kind == 0])]] = 2
        state[at[kind != 0]] = 0
        gone = order[at[kind == 0]]
        for i, (key, h) in enumerate(glist):
            drop = gone[(gone >= base[i]) & (gone < base[i + 1])] - base[i]
            if key == gkey:
                drop = np.union1d(drop, col[found])
            if drop.size:
                h.delete(np.unique(drop))
        keep = state != 0
        if keep.any():
            two = state[keep] == 2
            cols = [np.where(two, z[:, keep], p[:, keep])
                    for p, z in zip(post, zero)]
            g.insert(arr[keep], np.where(two, now, t[keep]), *cols)
            if gkey not in groups:
                groups[gkey] = g
        for key in [key for key, h in groups.items() if not h.shards.size]:
            del groups[key]
        self._count = sum(h.shards.size for h in groups.values())

    def _spill_order(self, m: int, pos, s_sc, s_gr, s_sh, b, f, grk: int,
                     arr, scalar: bool) -> tuple:
        """The entries spilled by a charge, in order: (kind, at) arrays,
        kind 0 for a tracked entry at sorted position `at`, 1 or 2 for the
        charge's key `at` charged from its state or from zero. pos: each
        key's sorted position (-1: not tracked); s_*: the sorted entries'
        scores and keys; b, f: each key's score after the charge from its
        state and from zero."""
        n = arr.size
        new = pos < 0
        cold = self._coldest(m, pos, new, s_sc, s_gr, s_sh, b, f, grk, arr)
        if cold is not None:
            return cold
        # otherwise the JAX order, key by key: the sorted entries are
        # popped from the front (skipping those charged since), the
        # charge's keys from a heap
        alive = bytearray(b"\x01") * m
        s_sc, s_gr, s_sh = s_sc.tolist(), s_gr.tolist(), s_sh.tolist()
        bl, fl, shl, pl = b.tolist(), f.tolist(), arr.tolist(), pos.tolist()
        f0 = fl[0]
        bulk_ok = scalar and bool((b[~new] >= f0).all())
        top = (f0, grk, shl[-1])
        kinds, ats, heap, tail = [], [], [], ([], [])
        count, cap, p = self._count, self.max_fragments, 0
        for t in range(n):
            q = pl[t]
            if q >= 0 and alive[q]:
                alive[q] = 0
                heapq.heappush(heap, (bl[t], grk, shl[t], t, 1))
                continue
            if count >= cap:
                while p < m and not alive[p]:
                    p += 1
                if p < m and (not heap or (s_sc[p], s_gr[p], s_sh[p])
                              < heap[0][:3]):
                    alive[p] = 0
                    kinds.append(0)
                    ats.append(p)
                    p += 1
                else:
                    item = heapq.heappop(heap)
                    kinds.append(item[4])
                    ats.append(item[3])
                    if bulk_ok and (p >= m or (s_sc[p], s_gr[p], s_sh[p])
                                    > top):
                        heapq.heappush(heap, (fl[t], grk, shl[t], t, 2))
                        tail = self._spill_tail(t + 1, heap, f0, pos, alive,
                                                b)
                        break
                count -= 1
            heapq.heappush(heap, (fl[t], grk, shl[t], t, 2))
            count += 1
        return (np.array(kinds + tail[0], dtype=np.int64),
                np.array(ats + tail[1], dtype=np.int64))

    def _coldest(self, m: int, pos, new, s_sc, s_gr, s_sh, b, f,
                 grk: int, arr):
        """The spill as _spill_order gives it where none of the charge's
        keys is spilled: the coldest other entries, as many as the new
        keys pass the bound, each below every key of the charge; else
        None."""
        kval = f.copy()
        kval[~new] = np.minimum(s_sc[pos[~new]], b[~new])
        others = np.ones(m, dtype=bool)
        others[pos[~new]] = False
        cand = np.flatnonzero(others)
        need = int(new.sum()) - (self.max_fragments - self._count)
        if need > cand.size:
            return None
        last = cand[need - 1]
        j = int(np.lexsort((arr, kval))[0])
        if (s_sc[last], s_gr[last], s_sh[last]) < (kval[j], grk, arr[j]):
            return np.zeros(need, dtype=np.int64), cand[:need]
        return None

    @staticmethod
    def _spill_tail(t0: int, heap: list, f0: float, pos: np.ndarray,
                    alive: bytearray, b: np.ndarray) -> tuple:
        """The rest of a charge, from key t0, once the table is full, the
        charge's keys all score at least the fresh score f0 and every
        tracked entry left is above all of them: each key not tracked at
        its turn spills the oldest of the keys at exactly f0 (they come in
        key order), so the spilled ones are the first of that queue.
        Returns their (kinds, keys) as lists."""
        q = pos[t0:]
        here = q >= 0
        here[here] = np.frombuffer(alive, dtype=np.uint8)[q[here]] != 0
        joins = here & (b[t0:] == f0)
        enter = joins | ~here
        head = sorted((it[3], it[4]) for it in heap if it[0] == f0)
        keys = [t for t, _ in head] + (np.flatnonzero(enter) + t0).tolist()
        kinds = [k for _, k in head] + np.where(joins, 1, 2)[enter].tolist()
        pops = int((~here).sum())
        return kinds[:pops], keys[:pops]

    # -- read side -------------------------------------------------------------

    def scores_for(self, keys, now: Optional[float] = None):
        """Scores of `keys` (0.0 for untracked), decaying what they find:
        a float64 array for a Frags, a list for a list of keys."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._drain_locked()
            if isinstance(keys, Frags):
                out = np.zeros(len(keys.shards))
                g = self._groups.get(keys[:3])
                if g is None or not out.size:
                    return out
                try:
                    arr, slots, found = g.locate(keys.shards)
                except ValueError:
                    return np.array(self._scores_keys(keys.keys(), now))
                if found is not None:
                    slots = slots[found]
                g.decay(slots, now)
                if found is None:
                    return g.scores(slots)
                out[found] = g.scores(slots)
                return out
            return self._scores_keys(keys, now)

    def _find(self, key) -> tuple:
        """(group, column) of a tracked key, or (group or None, None)."""
        g = self._groups.get(tuple(key[:3]))
        if g is None:
            return None, None
        j = int(np.searchsorted(g.shards, key[3]))
        if j < g.shards.size and g.shards[j] == key[3]:
            return g, j
        return g, None

    def _scores_keys(self, keys, now: float) -> list:
        out = []
        for key in keys:
            g, j = self._find(key)
            if j is None:
                out.append(0.0)
                continue
            g.decay(np.array([j]), now)
            out.append(float(g.scores(np.array([j]))[0]))
        return out

    def totals(self) -> dict:
        """Exact sums over every fragment ever charged, spill included."""
        with self._lock:
            self._drain_locked()
            out = dict(self._other)
            for g in self._groups.values():
                sums = g.acc.sum(axis=1)
                for i, f in enumerate(FIELDS):
                    out[f] += float(sums[i])
            return out

    def _scored_locked(self, now: float) -> list:
        scored = []
        for gkey, g in self._groups.items():
            g.decay(None, now)
            for j, (s, sc) in enumerate(zip(g.shards.tolist(),
                                            g.scores().tolist())):
                scored.append(((*gkey, s), g, j, sc))
        return scored

    @staticmethod
    def _entry_doc(key: tuple, g: _Group, j: int, score: float,
                   now: float) -> dict:
        index, field, view, shard = key
        lr, lw = float(g.last[0, j]), float(g.last[1, j])
        return {
            "index": index, "field": field, "view": view,
            "shard": int(shard),
            "score": round(score, 6),
            "readsPerS": round(float(g.ewma[0, j]) / HALF_LIVES[0], 6),
            "writesPerS": round(float(g.ewma[_N, j]) / HALF_LIVES[0], 6),
            "reads": round(float(g.acc[0, j]), 3),
            "writes": round(float(g.acc[1, j]), 3),
            "deviceMs": round(float(g.acc[2, j]), 3),
            "h2dBytes": round(float(g.acc[3, j]), 1),
            "uploads": round(float(g.acc[4, j]), 1),
            "evictions": round(float(g.acc[5, j]), 1),
            "lastReadAgeS": None if math.isnan(lr) else round(now - lr, 3),
            "lastWriteAgeS": None if math.isnan(lw) else round(now - lw, 3),
        }

    def snapshot(self, top: int = 20, now: Optional[float] = None) -> dict:
        """The /debug/heat document (JAX :306): `hot` by score desc and
        `cold` by score asc, `top` each (0: every entry in `hot`, no
        `cold`), exact totals, the score distribution, the hot count and
        the skew (hottest over mean score)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._drain_locked()
            scored = self._scored_locked(now)
            scored.sort(key=lambda t: (-t[3], t[0]))
            totals = dict(self._other)
            for g in self._groups.values():
                sums = g.acc.sum(axis=1)
                for i, f in enumerate(FIELDS):
                    totals[f] += float(sums[i])
            scores = [t[3] for t in scored]
            mean = (sum(scores) / len(scores)) if scores else 0.0
            skew = (scores[0] / mean) if mean > 0 else 1.0
            dist = {f"{b:g}": sum(1 for s in scores if s <= b)
                    for b in DISTRIBUTION_BOUNDS}
            dist["+Inf"] = len(scores)
            hot = [self._entry_doc(k, g, j, s, now)
                   for k, g, j, s in (scored[:top] if top > 0 else scored)]
            cold = []
            if top > 0:
                cold = [self._entry_doc(k, g, j, s, now)
                        for k, g, j, s in sorted(
                            scored, key=lambda t: (t[3], t[0]))[:top]]
            return {
                "hot": hot,
                "cold": cold,
                "totals": {f: round(v, 3) for f, v in totals.items()},
                "trackedFragments": len(scored),
                "spilledFragments": self.spilled_fragments,
                "maxFragments": self.max_fragments,
                "hotFragments": sum(1 for s in scores if s >= HOT_SCORE),
                "skew": round(skew, 4),
                "distribution": dist,
            }

    def sample_tick(self, ts: Optional[float] = None,
                    now: Optional[float] = None) -> dict:
        """One aggregate summary into the ring (the telemetry sampler
        drives it), returned for the heat.* gauges."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._drain_locked()
            parts = []
            for g in self._groups.values():
                g.decay(None, now)
                parts.append(g.scores())
            scores = np.concatenate(parts) if parts else np.empty(0)
            mean = sum(scores.tolist()) / scores.size if scores.size else 0.0
            summary = {
                "hotFragments": int((scores >= HOT_SCORE).sum()),
                "skew": round(float(scores.max()) / mean, 4)
                if mean > 0 else 1.0,
                "trackerEntries": int(scores.size),
            }
        self.ring.append(summary, ts=ts)
        return summary

    def since(self, cursor: int = 0, limit: int = 0) -> dict:
        return self.ring.since(cursor, limit)

    def drop_field(self, index: str, field: str) -> None:
        """Forget a deleted field's fragments (what spilled of them stays
        in the spill aggregate)."""
        with self._lock:
            self._drain_locked()
            for gkey in [k for k in self._groups
                         if k[0] == index and k[1] == field]:
                self._count -= self._groups.pop(gkey).shards.size

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._groups.clear()
            self._count = 0
            self._other = dict.fromkeys(FIELDS, 0.0)
            self.spilled_fragments = 0


def merge_heat_docs(docs: dict) -> dict:
    """The fleet's heat map (GET /cluster/heat) from each node's
    /debug/heat document (copy of pilosa_tpu/utils/heat.py:390): a
    fragment's fields and scores sum over the nodes that report it (two
    replicas serving its reads make it twice as hot fleet-wide), totals
    and spills sum, and the skew is recomputed over the merged scores.
    `docs` maps node id -> that node's document."""
    merged: dict = {}
    totals = dict.fromkeys(FIELDS, 0.0)
    spilled = 0
    for doc in docs.values():
        for e in (doc.get("hot") or []):
            key = (e.get("index"), e.get("field"), e.get("view"),
                   int(e.get("shard", 0)))
            acc = merged.get(key)
            if acc is None:
                acc = merged[key] = {
                    "index": key[0], "field": key[1], "view": key[2],
                    "shard": key[3], "score": 0.0, "readsPerS": 0.0,
                    "writesPerS": 0.0, "nodes": 0,
                    **{f: 0.0 for f in FIELDS}}
            for f in FIELDS:
                acc[f] = round(acc[f] + float(e.get(f, 0.0)), 3)
            for f in ("score", "readsPerS", "writesPerS"):
                acc[f] = round(acc[f] + float(e.get(f, 0.0)), 6)
            acc["nodes"] += 1
        for f in FIELDS:
            totals[f] += float((doc.get("totals") or {}).get(f, 0.0))
        spilled += int(doc.get("spilledFragments", 0))
    ordered = sorted(merged.values(),
                     key=lambda e: (-e["score"], e["index"], e["field"],
                                    e["view"], e["shard"]))
    scores = [e["score"] for e in ordered]
    mean = (sum(scores) / len(scores)) if scores else 0.0
    return {
        "hot": ordered,
        "totals": {f: round(v, 3) for f, v in totals.items()},
        "trackedFragments": len(ordered),
        "spilledFragments": spilled,
        "hotFragments": sum(1 for s in scores if s >= HOT_SCORE),
        "skew": round(scores[0] / mean, 4) if mean > 0 else 1.0,
    }
