"""Frozen (array-backed) container store: the billion-row bulk-load path.

Copy of pilosa_tpu/storage/frozen.py (:46-651), imports repointed at the
port's roaring module. A dict store holds one Python Container object per
2^16-position keyspace; a bulk load of a BASELINE-scale index (configs
2-3: 100M-1B rows, so at least one container per row) would allocate
hundreds of millions of them. FrozenContainers keeps the whole store as
three flat numpy arrays:

    keys    int64[Nc]    sorted container keys
    offsets int64[Nc+1]  value-range per key
    lows    uint16[N]    concatenated sorted low-16 members

built in O(N log N) numpy from the position array of a bulk import
(`from_positions`). Containers materialize on access, so a query pays only
for the containers of the rows it reads. Mutations go to an overlay dict
(copy-on-write per container) with a deletion set; the frozen base never
changes. Snapshots serialize the arrays directly (`write_pilosa`), and a
file of at least FROZEN_PARSE_MIN containers parses back into one
(`parse_pilosa_frozen`) with zero-copy views of its array payloads.

Every caller that special-cases this store probes the one capability
marker VECTORIZED_STORE.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator, Optional

import numpy as np

from pilosa_tpu_torch.storage.roaring import (
    ARRAY_MAX_SIZE,
    HEADER_BASE_SIZE,
    MAGIC_NUMBER,
    STORAGE_VERSION,
    TYPE_ARRAY,
    TYPE_BITMAP,
    Container,
    _array_to_words,
    _payload_size,
    container_contains_many,
)

__all__ = ["FrozenContainers"]


class FrozenContainers:
    """Mapping-protocol container store over flat arrays + a COW overlay.

    Satisfies everything Bitmap expects of a store (get/item access,
    iteration in key order, irange/first_key/last_key) plus vectorized
    fast paths (`key_and_count_arrays`, `total_count`) that Bitmap and
    Fragment use to avoid materializing the corpus.
    """

    # THE capability marker: every caller that special-cases this store
    # (vectorized aggregation, store-owned serialization, skipped
    # per-container walks) probes this one attribute — not scattered
    # hasattr checks on unrelated method names
    VECTORIZED_STORE = True

    def __init__(self, keys: np.ndarray, offsets: np.ndarray,
                 lows: np.ndarray, ends: Optional[np.ndarray] = None):
        """offsets: value-range starts per key; without `ends`, container i
        spans offsets[i]:offsets[i+1] (contiguous lows, the from_positions
        layout). With `ends` (the zero-copy file-parse layout, where
        bitmap/run payload bytes sit between array payloads in the same
        buffer) container i spans offsets[i]:ends[i]."""
        if ends is None:
            assert keys.ndim == 1 and offsets.shape == (keys.size + 1,)
            starts, ends = offsets[:-1], offsets[1:]
        else:
            starts = offsets
            assert keys.shape == starts.shape == ends.shape
        self._keys = keys.astype(np.int64, copy=False)
        self._starts = starts.astype(np.int64, copy=False)
        self._ends = ends.astype(np.int64, copy=False)
        self._lows = lows.astype(np.uint16, copy=False)
        self._overlay: dict[int, Container] = {}
        self._deleted: set[int] = set()
        self._version = 0  # bumped per mutation; memo key for the
        # vectorized aggregates (a file-parsed store carries its dense
        # bitmap/run containers in the overlay, and recomputing the merge
        # per call would cost an O(Nc) sort each time)
        self._kca_cache = None

    # -- construction -------------------------------------------------------

    # a container leaves the flat lows for a run-encoded overlay entry only
    # when the run form is at least this many times smaller than the array
    # form AND the container is big enough for the dict entry to pay off —
    # sequential/fully-set shapes (existence rows, time views) qualify,
    # random sparse data never does (countRuns heuristic,
    # the reference's roaring/roaring.go:1261,1594 — tuned for a store
    # whose base cost is flat uint16 arrays, not per-container objects)
    RUNIFY_MIN_CARD = 4096
    RUNIFY_FACTOR = 8

    @classmethod
    def from_positions(cls, positions: np.ndarray) -> "FrozenContainers":
        """Sorted-unique uint64 bit positions -> frozen store, all numpy.

        Runny containers (long consecutive stretches) are detected with one
        vectorized diff pass and stored run-encoded in the overlay instead
        of inflating the flat lows: a fully-set existence container costs
        one (0, 65535) interval, not 128 KiB of uint16s — at a 1B-column
        corpus that is the difference between KBs and GBs of RSS for the
        existence/time views."""
        positions = np.asarray(positions, dtype=np.uint64)
        keys64 = (positions >> np.uint64(16)).astype(np.int64)
        lows = (positions & np.uint64(0xFFFF)).astype(np.uint16)
        # positions are sorted-unique, so keys are sorted: container
        # boundaries fall out of one diff pass (np.unique would pay a
        # redundant O(N log N) sort per shard at bulk-load scale)
        if keys64.size:
            starts = np.flatnonzero(
                np.concatenate([[True], keys64[1:] != keys64[:-1]]))
        else:
            starts = np.empty(0, dtype=np.int64)
        ukeys = keys64[starts]
        offsets = np.empty(ukeys.size + 1, dtype=np.int64)
        offsets[:-1] = starts
        offsets[-1] = keys64.size
        if positions.size:
            counts = np.diff(offsets)
            # element i starts a run unless it continues element i-1 within
            # the same container
            run_start = np.ones(positions.size, dtype=bool)
            run_start[1:] = np.diff(positions) != 1
            run_start[starts] = True
            nruns = np.add.reduceat(run_start, offsets[:-1])
            runny = ((counts >= cls.RUNIFY_MIN_CARD)
                     & (nruns * cls.RUNIFY_FACTOR * 2 <= counts))
            if runny.any():
                start_idx = np.flatnonzero(run_start)
                # run r spans [start_idx[r], next start or container end)
                run_container = np.searchsorted(
                    offsets[:-1], start_idx, side="right") - 1
                run_last = np.empty(start_idx.size, dtype=np.int64)
                run_last[:-1] = start_idx[1:] - 1
                run_last[-1] = positions.size - 1
                # runs never span containers (run_start forced at starts),
                # so clipping to the container end is already implied
                # run_container is non-decreasing, so each runny
                # container's runs are one contiguous slice — two binary
                # searches per container, never a full rescan
                overlay_items = []
                for ci in np.flatnonzero(runny):
                    lo = np.searchsorted(run_container, ci, side="left")
                    hi = np.searchsorted(run_container, ci, side="right")
                    iv = np.stack([lows[start_idx[lo:hi]],
                                   lows[run_last[lo:hi]]], axis=1)
                    overlay_items.append((int(ukeys[ci]),
                                          Container("run", iv)))
                keep = ~runny
                keep_elems = np.repeat(keep, counts)
                lows = lows[keep_elems]
                kept_counts = counts[keep]
                offsets = np.empty(int(keep.sum()) + 1, dtype=np.int64)
                offsets[0] = 0
                np.cumsum(kept_counts, out=offsets[1:])
                ukeys = ukeys[keep]
                store = cls(ukeys, offsets, lows)
                for k, c in overlay_items:
                    store._overlay[k] = c
                return store
        return cls(ukeys, offsets, lows)

    @classmethod
    def empty(cls) -> "FrozenContainers":
        return cls(np.empty(0, np.int64), np.zeros(1, np.int64),
                   np.empty(0, np.uint16))

    # -- base access --------------------------------------------------------

    def _base_idx(self, key: int) -> int:
        i = int(np.searchsorted(self._keys, key))
        if i < self._keys.size and int(self._keys[i]) == key:
            return i
        return -1

    def _materialize(self, i: int) -> Container:
        vals = self._lows[self._starts[i]:self._ends[i]]
        if vals.size > ARRAY_MAX_SIZE:
            return Container.from_values(vals)  # picks bitmap
        return Container("array", vals)

    # -- mapping protocol ---------------------------------------------------

    def get(self, key: int, default: Any = None) -> Optional[Container]:
        c = self._overlay.get(key)
        if c is not None:
            return c
        if key in self._deleted:
            return default
        i = self._base_idx(key)
        return self._materialize(i) if i >= 0 else default

    def __getitem__(self, key: int) -> Container:
        c = self.get(key)
        if c is None:
            raise KeyError(key)
        return c

    def __contains__(self, key: object) -> bool:
        return self.get(key) is not None  # type: ignore[arg-type]

    def __setitem__(self, key: int, c: Container) -> None:
        self._overlay[int(key)] = c
        self._deleted.discard(int(key))
        self._version += 1

    def __delitem__(self, key: int) -> None:
        had = key in self
        self._overlay.pop(int(key), None)
        if self._base_idx(int(key)) >= 0:
            self._deleted.add(int(key))
        elif not had:
            raise KeyError(key)
        self._version += 1

    def pop(self, key: int, default: Any = None):
        c = self.get(key)
        if c is not None:
            del self[key]
        return c if c is not None else default

    def __iter__(self) -> Iterator[int]:
        return self.irange(None, None)

    def keys(self) -> Iterator[int]:
        return iter(self)

    def __len__(self) -> int:
        n = self._keys.size - len(self._deleted)
        return n + sum(1 for k in self._overlay if self._base_idx(k) < 0)

    def items(self):
        for k in self:
            yield k, self[k]

    def values(self):
        for k in self:
            yield self[k]

    # -- ordered-store protocol (matches BTreeContainers) -------------------

    def irange(self, lo: Optional[int], hi: Optional[int]) -> Iterator[int]:
        """Keys in [lo, hi] ascending, overlay-merged (hi inclusive, like
        BTreeContainers.irange)."""
        i = 0 if lo is None else int(np.searchsorted(self._keys, lo))
        extra = sorted(k for k in self._overlay
                       if self._base_idx(k) < 0
                       and (lo is None or k >= lo)
                       and (hi is None or k <= hi))
        e = 0
        while i < self._keys.size or e < len(extra):
            base_k = int(self._keys[i]) if i < self._keys.size else None
            if base_k is not None and (hi is not None and base_k > hi):
                base_k = None
            ext_k = extra[e] if e < len(extra) else None
            if base_k is None and ext_k is None:
                return
            if ext_k is None or (base_k is not None and base_k < ext_k):
                i += 1
                if base_k in self._deleted:
                    continue
                yield base_k
            else:
                e += 1
                yield ext_k

    def first_key(self) -> int:
        for k in self:
            return k
        raise KeyError("empty store")

    def last_key(self) -> int:
        # base tail, skipping deleted; vs max overlay-only key
        last_base = None
        for i in range(self._keys.size - 1, -1, -1):
            k = int(self._keys[i])
            if k not in self._deleted:
                last_base = k
                break
        extra = [k for k in self._overlay if self._base_idx(k) < 0]
        if extra or last_base is not None:
            return max([k for k in (last_base,) if k is not None] + extra)
        raise KeyError("empty store")

    def __bool__(self) -> bool:
        if self._overlay:
            return True
        return self._keys.size > len(self._deleted)

    # -- vectorized fast paths ----------------------------------------------

    def key_and_count_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys, cardinalities) for the WHOLE store as int64 arrays with
        no Container materialization — what Fragment.row_counts and
        rank-cache building aggregate over at bulk-load scale."""
        base_n = self._ends - self._starts
        if not self._overlay and not self._deleted:
            return self._keys, base_n
        cached = self._kca_cache
        if cached is not None and cached[0] == self._version:
            return cached[1], cached[2]
        keep = np.ones(self._keys.size, dtype=bool)
        for k in self._deleted:
            i = self._base_idx(k)
            if i >= 0:
                keep[i] = False
        # overlay replaces base entries (mutated) and adds new keys
        ov_keys = np.fromiter(self._overlay.keys(), np.int64,
                              len(self._overlay))
        for j, k in enumerate(ov_keys):
            i = self._base_idx(int(k))
            if i >= 0:
                keep[i] = False
        ov_n = np.fromiter((c.n for c in self._overlay.values()), np.int64,
                           len(self._overlay))
        keys = np.concatenate([self._keys[keep], ov_keys])
        ns = np.concatenate([base_n[keep], ov_n])
        order = np.argsort(keys, kind="stable")
        out = (keys[order], ns[order])
        self._kca_cache = (self._version, out[0], out[1])
        return out

    def total_count(self) -> int:
        keys, ns = self.key_and_count_arrays()
        return int(ns.sum())

    def all_positions(self) -> np.ndarray:
        """Every set position as one sorted uint64 array, pure array math
        (no Container materialization): repeat each key over its
        cardinality and OR in the flat lows."""
        keys, counts, lows, _starts, _ends = self._compact_arrays()
        if keys.size == 0:
            return np.empty(0, dtype=np.uint64)
        return (np.repeat(keys.astype(np.uint64) << np.uint64(16),
                          counts.astype(np.int64))
                | lows.astype(np.uint64))

    def contains_positions(self, positions: np.ndarray) -> np.ndarray:
        """Vectorized membership for a batch of uint64 positions: one
        searchsorted to resolve keys, one gather of ONLY the probed
        containers' lows, one searchsorted for the low words — cost
        O(bits in probed containers), never O(store). rows_for_column
        probes frozen corpus-scale fragments through this."""
        positions = np.asarray(positions, dtype=np.uint64)
        out = np.zeros(positions.size, dtype=bool)
        if positions.size == 0:
            return out
        qkeys = (positions >> np.uint64(16)).astype(np.int64)
        qlows = (positions & np.uint64(0xFFFF)).astype(np.uint16)
        pending = np.ones(positions.size, dtype=bool)
        # overlay first: one sorted join resolves which queries land in
        # overlay containers (runified stores can hold thousands of
        # entries — a per-entry scan of the batch would be quadratic)
        if self._overlay:
            ov_keys = np.fromiter(self._overlay.keys(), np.int64,
                                  len(self._overlay))
            ov_keys.sort()
            oi = np.searchsorted(ov_keys, qkeys)
            oic = np.minimum(oi, ov_keys.size - 1)
            in_ov = (oi < ov_keys.size) & (ov_keys[oic] == qkeys)
            hits = np.nonzero(in_ov)[0]
            if hits.size:
                grouped = hits[np.argsort(qkeys[hits], kind="stable")]
                bounds = np.flatnonzero(np.diff(qkeys[grouped])) + 1
                for grp in np.split(grouped, bounds):
                    c = self._overlay[int(qkeys[grp[0]])]
                    if c.n:
                        out[grp] = container_contains_many(c, qlows[grp])
            pending &= ~in_ov
        if self._deleted:
            dead = np.isin(qkeys, np.fromiter(self._deleted, np.int64,
                                              len(self._deleted)))
            pending &= ~dead
        if self._keys.size == 0 or not pending.any():
            return out
        qi = np.nonzero(pending)[0]
        i = np.searchsorted(self._keys, qkeys[qi])
        ic = np.minimum(i, self._keys.size - 1)
        hit = (i < self._keys.size) & (self._keys[ic] == qkeys[qi])
        if not hit.any():
            return out
        qi, seg = qi[hit], ic[hit]
        # gather the probed containers' lows into one flat sorted-by-
        # (key, low) array, then one global searchsorted answers all
        useg = np.unique(seg)
        counts = self._ends[useg] - self._starts[useg]
        g_ends = np.cumsum(counts)
        g_starts = g_ends - counts
        total = int(g_ends[-1])
        gather = (np.arange(total, dtype=np.int64)
                  + np.repeat(self._starts[useg] - g_starts, counts))
        gpos = (np.repeat(self._keys[useg].astype(np.uint64) << np.uint64(16),
                          counts)
                | self._lows[gather].astype(np.uint64))
        j = np.searchsorted(gpos, positions[qi])
        jc = np.minimum(j, gpos.size - 1)
        out[qi] = (j < gpos.size) & (gpos[jc] == positions[qi])
        return out

    # -- serialization (the 1B-scale snapshot path) -------------------------

    def _base_compact(self):
        """Kept base containers — deleted and overlay-replaced keys
        excluded — compacted to (keys, counts, lows, starts, ends) with
        lows contiguous (ends[i] == starts[i+1]). Zero-copy views when the
        base layout is already contiguous (the from_positions shape);
        otherwise one vectorized multi-slice gather (file-parsed layouts
        with payload gaps, or deletions) — a per-container Python loop
        here would reintroduce the 1B-container cost this store removes."""
        keep = np.ones(self._keys.size, dtype=bool)
        for k in self._deleted:
            i = self._base_idx(k)
            if i >= 0:
                keep[i] = False
        for k in self._overlay:
            i = self._base_idx(k)
            if i >= 0:
                keep[i] = False
        bkeys = self._keys[keep]
        bstarts, bends = self._starts[keep], self._ends[keep]
        counts = bends - bstarts
        contiguous = (keep.all() and bkeys.size > 0
                      and int(bstarts[0]) == 0
                      and (bkeys.size == 1
                           or bool((bends[:-1] == bstarts[1:]).all())))
        if contiguous:
            return bkeys, counts, self._lows, bstarts, bends
        out_ends = np.cumsum(counts)
        out_starts = out_ends - counts
        if bkeys.size:
            total = int(counts.sum())
            idx = (np.arange(total, dtype=np.int64)
                   + np.repeat(bstarts - out_starts, counts))
            lows = self._lows[idx]
        else:
            lows = np.empty(0, dtype=np.uint16)
        return bkeys, counts, lows, out_starts, out_ends

    def _compact_arrays(self):
        """(keys, counts, lows, starts, ends) with the overlay/deletions
        folded in and lows CONTIGUOUS — the shape the vectorized
        aggregates want. Overlay containers (few) splice in per entry,
        expanded to their member values."""
        bkeys, counts, base_lows, out_starts, out_ends = self._base_compact()
        if not self._overlay:
            return bkeys, counts, base_lows, out_starts, out_ends
        # overlay present: splice its (few) containers into the flat form
        ov = sorted((k, self._overlay[k].values())
                    for k in self._overlay if self._overlay[k].n > 0)
        key_pieces, low_pieces, cnt_pieces = [], [], []
        pos = 0  # index into bkeys
        for k, vals in ov:
            cut = int(np.searchsorted(bkeys, k))
            if cut > pos:
                key_pieces.append(bkeys[pos:cut])
                cnt_pieces.append(counts[pos:cut])
                low_pieces.append(
                    base_lows[out_starts[pos]:out_ends[cut - 1]])
            key_pieces.append(np.array([k], dtype=np.int64))
            cnt_pieces.append(np.array([vals.size], dtype=np.int64))
            low_pieces.append(vals.astype(np.uint16))
            pos = cut
        if pos < bkeys.size:
            key_pieces.append(bkeys[pos:])
            cnt_pieces.append(counts[pos:])
            low_pieces.append(base_lows[out_starts[pos]:])
        keys = (np.concatenate(key_pieces) if key_pieces
                else np.empty(0, np.int64))
        cnts = (np.concatenate(cnt_pieces) if cnt_pieces
                else np.empty(0, np.int64))
        lows = (np.concatenate(low_pieces) if low_pieces
                else np.empty(0, np.uint16))
        ends = np.cumsum(cnts)
        starts = ends - cnts
        return keys, cnts, lows, starts, ends

    def write_pilosa(self, w) -> int:
        """Serialize in Pilosa roaring format with NO per-container Python
        on the hot path: metadata (desc records + offset table) is built
        as numpy structured arrays, and payload bytes for consecutive
        array-encoded containers are written as single contiguous slices
        of the flat value array. Only the (few) overlay containers —
        run-encoded existence/time shapes, bitmap-dense mutations — pay a
        per-container encode, and they keep their native encoding on disk
        (a fully-set container writes as one TYPE_RUN interval, not 8 KiB
        of bitmap). This is what makes snapshot() of a billion-row frozen
        fragment seconds of array writes instead of hours of Container
        marshaling (roaring.go:1387-1454 writeToUnoptimized's layout)."""
        # base part: kept containers compacted so consecutive array
        # payloads stream as single slices
        bkeys, bcounts, blows, b_starts, b_ends = self._base_compact()
        # overlay: few containers, encoded natively (optimize picks the
        # smallest of array/bitmap/run, reference roaring.go:1594)
        ov = sorted((int(k), c.optimize()) for k, c in self._overlay.items()
                    if c.n > 0)
        ov_enc = [(k,) + c.encode_current() + (c.n,) for k, c in ov]
        nb, no = bkeys.size, len(ov_enc)
        nc = nb + no
        # merged key order: base order is preserved, overlay splices in
        all_keys = np.concatenate(
            [bkeys, np.array([e[0] for e in ov_enc], dtype=np.int64)])
        all_counts = np.concatenate(
            [bcounts, np.array([e[3] for e in ov_enc], dtype=np.int64)])
        b_is_arr = bcounts <= ARRAY_MAX_SIZE
        all_codes = np.concatenate(
            [np.where(b_is_arr, TYPE_ARRAY, TYPE_BITMAP).astype(np.int64),
             np.array([e[1] for e in ov_enc], dtype=np.int64)])
        all_sizes = np.concatenate(
            [np.where(b_is_arr, 2 * bcounts, 8 * 1024),
             np.array([len(e[2]) for e in ov_enc], dtype=np.int64)])
        order = np.argsort(all_keys, kind="stable")
        keys_m = all_keys[order]
        counts_m = all_counts[order]
        codes_m = all_codes[order]
        sizes_m = all_sizes[order]
        desc = np.empty(nc, dtype=[("k", "<u8"), ("code", "<u2"),
                                   ("nm1", "<u2")])
        desc["k"] = keys_m.astype(np.uint64)
        desc["code"] = codes_m
        desc["nm1"] = (counts_m - 1).astype(np.uint64)
        base = HEADER_BASE_SIZE + nc * 12 + nc * 4
        file_off = np.empty(nc, dtype=np.int64)
        if nc:
            np.cumsum(sizes_m[:-1], out=file_off[1:])
            file_off[0] = 0
            file_off += base
        if nc and int(file_off[-1]) + int(sizes_m[-1]) > 0xFFFFFFFF:
            # the offset table is u32 by format; fail loudly like the
            # dict-store writer's struct.pack would, never wrap silently
            raise ValueError(
                f"snapshot payload region exceeds the format's 4 GiB "
                f"offset space ({int(file_off[-1]) + int(sizes_m[-1])} bytes)"
                " — split the fragment")
        written = 0
        written += w.write(struct.pack("<HHI", MAGIC_NUMBER,
                                        STORAGE_VERSION, nc))
        written += w.write(memoryview(desc))  # no multi-GB bytes copies:
        written += w.write(memoryview(file_off.astype("<u4")))
        # payloads in merged order: stream maximal streaks of consecutive
        # base array containers as one buffer view (their relative order —
        # and so their compacted contiguity — survives the merge); bitmap
        # and overlay containers emit individually
        lows_le = np.ascontiguousarray(blows.astype("<u2", copy=False))
        i = 0
        while i < nc:
            src = int(order[i])
            if src < nb and b_is_arr[src]:
                j = i
                while j < nc and int(order[j]) < nb \
                        and b_is_arr[int(order[j])]:
                    j += 1
                first, last = int(order[i]), int(order[j - 1])
                written += w.write(
                    memoryview(lows_le[b_starts[first]:b_ends[last]]))
                i = j
            elif src < nb:
                words = _array_to_words(blows[b_starts[src]:b_ends[src]])
                written += w.write(memoryview(words.astype("<u8")))
                i += 1
            else:
                written += w.write(ov_enc[src - nb][2])
                i += 1
        return written


# threshold above which from_bytes parses straight into a frozen store
# (per-container Python at file-open time stops being viable)
FROZEN_PARSE_MIN = 65536


def parse_pilosa_frozen(data, key_n: int, desc_off: int, off_off: int):
    """Vectorized parse of a Pilosa roaring snapshot section into a
    FrozenContainers store: metadata via zero-copy structured views,
    array payloads as element ranges into ONE uint16 view of the buffer
    (mmap-friendly: nothing is copied but the key/offset columns),
    bitmap/run containers (rare at this scale) materialize into the COW
    overlay. Returns (store, ops_offset) — the op-log tail position."""
    desc = np.frombuffer(data, dtype=[("k", "<u8"), ("code", "<u2"),
                                      ("nm1", "<u2")],
                         count=key_n, offset=desc_off)
    offs = np.frombuffer(data, dtype="<u4", count=key_n, offset=off_off)
    counts = desc["nm1"].astype(np.int64) + 1
    codes = desc["code"]
    is_arr = codes == TYPE_ARRAY
    n_bytes = len(data)
    # bounds validation, vectorized for the array containers
    arr_ends = offs.astype(np.int64) + 2 * counts
    if is_arr.any():
        bad = is_arr & ((offs.astype(np.int64) % 2 != 0)
                        | (arr_ends > n_bytes))
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"container payload out of bounds: off={int(offs[i])}, "
                f"size={2 * int(counts[i])}, len={n_bytes}")
    lows = np.frombuffer(data, dtype="<u2", count=n_bytes // 2)
    keys = desc["k"].astype(np.int64)
    if keys.size > 1 and not bool((np.diff(keys) > 0).all()):
        # the store binary-searches keys: an unsorted (corrupt / foreign)
        # desc section must fail loudly, not silently miss lookups
        raise ValueError("container keys not strictly ascending")
    starts16 = np.where(is_arr, offs.astype(np.int64) // 2, 0)
    ends16 = starts16 + np.where(is_arr, counts, 0)
    store = FrozenContainers(keys[is_arr], starts16[is_arr],
                             lows, ends=ends16[is_arr])
    ops_offset = off_off + key_n * 4  # overwritten below (key_n > 0)
    # non-array containers into the overlay (few: bitmap/run encodings
    # appear for dense containers — BSI planes, time views)
    for i in np.flatnonzero(~is_arr):
        off = int(offs[i])
        size = _payload_size(int(codes[i]), int(counts[i]), data, off)
        if off + size > n_bytes:
            raise ValueError(
                f"container payload out of bounds: off={off}, "
                f"size={size}, len={n_bytes}")
        c, _ = Container.from_payload(int(codes[i]), int(counts[i]),
                                      memoryview(data)[off:])
        store[int(keys[i])] = c
    if key_n:
        last = int(np.argmax(offs))
        last_size = (2 * int(counts[last]) if is_arr[last] else
                     _payload_size(int(codes[last]), int(counts[last]),
                                   data, int(offs[last])))
        ops_offset = int(offs[last]) + last_size
    return store, ops_offset
