"""Dense shard-bitvector algebra and popcounts in plain torch.

Trimmed port of pilosa_tpu/ops/bitvector.py:37-131 (dense algebra and
popcounts), the GroupBy chunk helpers (:158-221), the ingest patches of
resident leaves with their sorted-membership helper (:292, :629-660), and
numpy copies of its host conversions: dense_from_columns (:788), and
columns_from_planes, which decodes a whole [S, W] result the way
columns_from_dense (:803) decodes one row.

Planes are int32 tensors, bit-identical views of the reference's uint32
words. The bitwise ops act on bits, so signedness does not matter there.
The popcount is SWAR on values widened to int64 first: an arithmetic >> on
a negative int32 would drag the sign bit into the count. Per-row counts
are int32 (a shard row holds at most 2^20 bits); totals finish in int64.

These are the plain versions. The hot loops run through the kernels in
ops/kernels.py, which use the functions here as their reference.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.constants import SHARD_WIDTH, WORD_BITS
from pilosa_tpu_torch.parallel.blocks import Blocked, blockwise


@blockwise("map", None)
def band(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection: a & b."""
    return torch.bitwise_and(a, b)


@blockwise("map", None)
def bor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union: a | b."""
    return torch.bitwise_or(a, b)


@blockwise("map", None)
def bxor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric difference: a ^ b."""
    return torch.bitwise_xor(a, b)


@blockwise("map", None)
def bandnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Difference: a &~ b."""
    return torch.bitwise_and(a, torch.bitwise_not(b))


@blockwise("map", None)
def bnot(a: torch.Tensor) -> torch.Tensor:
    """Complement over the full shard width (the executor intersects with
    the existence row for Not() semantics)."""
    return torch.bitwise_not(a)


def word_popcounts(x: torch.Tensor) -> torch.Tensor:
    """Set bits of every 32-bit word -> int64 tensor of x's shape (SWAR)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits, reduced over the last (word) axis -> int32."""
    return word_popcounts(x).sum(dim=-1).to(torch.int32)


def intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(band(a, b))


def union_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(bor(a, b))


def difference_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(bandnot(a, b))


def xor_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(bxor(a, b))


def total_count(per_shard: torch.Tensor) -> int:
    """Exact int64 host finish of per-shard int32 counts."""
    return int(per_shard.detach().cpu().numpy().astype(np.int64).sum())


# ---------------------------------------------------------------------------
# GroupBy chunk helpers: one level of the cross product is a [P, R] count
# matrix of P prefixes (ANDs of rows of the axes consumed so far) against
# the R rows of the next axis, pruned to its nonzero entries on the device.
# `cross_fn` is the matrix kernel, ops/kernels.py cross_count_matrix unless
# a caller passes another (the tests pass the plain version).
# ---------------------------------------------------------------------------


def gather_prefix(axis_slabs, idx) -> torch.Tensor:
    """AND of the rows idx[k] of axis_slabs[k] -> [chunk, S, W]."""
    dev = axis_slabs[0].device
    pref = None
    for slab, ix in zip(axis_slabs, idx):
        rows = slab.index_select(0, torch.as_tensor(ix, dtype=torch.int64,
                                                    device=dev))
        pref = rows if pref is None else pref.bitwise_and_(rows)
    return pref


def mask_prefix_rows(cmat: torch.Tensor, n_valid: int,
                     n_rows: int) -> torch.Tensor:
    """cmat [n_valid, R] padded with zero rows to [n_rows, R]: a chunk's
    padding prefixes count nothing (the JAX package crosses the padding and
    zeroes it afterwards; here it is never crossed)."""
    if n_rows == n_valid:
        return cmat
    out = cmat.new_zeros((n_rows, cmat.shape[1]))
    out[:n_valid] = cmat[:n_valid]
    return out


def live_from_matrix(cmat: torch.Tensor, bound: int):
    """On-device zero pruning -> (n_live, flat_idx[bound], counts[bound]).

    flat_idx ascends over the row-major flattening of cmat (the
    reference's lexicographic group order); slots past the live count hold
    the sentinel P * R with count 0. n_live is the true number of nonzero
    entries: above `bound` the caller refetches the whole matrix. No host
    sync: the live entries are placed by a prefix sum and a scatter."""
    flat = cmat.reshape(-1)
    n = flat.shape[0]
    live = flat != 0
    n_live = live.sum()
    pos = torch.cumsum(live, dim=0) - 1
    slot = torch.where(live & (pos < bound), pos, bound)
    idx = torch.full((bound + 1,), n, dtype=torch.int64, device=flat.device)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int64,
                                       device=flat.device))
    idx = idx[:bound]
    counts = torch.where(idx < n, flat[idx.clamp(max=max(n - 1, 0))], 0)
    return n_live, idx.to(torch.int32), counts


def chunk_count_matrix(axis_slabs, idx, axis: torch.Tensor, n_valid: int,
                       cross_fn=None) -> torch.Tensor:
    """[len(idx[0]), R] count matrix of one chunk: the first n_valid
    prefixes gathered and crossed with `axis`, padding rows zero."""
    if cross_fn is None:
        from pilosa_tpu_torch.ops.kernels import cross_count_matrix

        cross_fn = cross_count_matrix
    n_valid = int(n_valid)
    valid = [np.asarray(ix)[:n_valid] for ix in idx]
    cmat = cross_fn(gather_prefix(axis_slabs, valid), axis)
    return mask_prefix_rows(cmat, n_valid, len(idx[0]))


def groupby_chunk_live(axis_slabs, idx, axis: torch.Tensor, n_valid: int,
                       bound: int, cross_fn=None):
    """One GroupBy level chunk: count matrix and zero pruning, all on the
    device (device tensors out; the executor fetches a level at once)."""
    cmat = chunk_count_matrix(axis_slabs, idx, axis, n_valid, cross_fn)
    return live_from_matrix(cmat, bound)


def groupby_chunk_matrix(axis_slabs, idx, axis: torch.Tensor, n_valid: int,
                         cross_fn=None) -> torch.Tensor:
    """The whole [chunk, R] count matrix: the refetch when a chunk's live
    set overflows the pruning bound."""
    return chunk_count_matrix(axis_slabs, idx, axis, n_valid, cross_fn)


# ---------------------------------------------------------------------------
# Ingest patches of resident leaves. A batch's net effect is reduced on the
# host to per-word masks (dense) or per-shard sorted add/remove arrays
# (sparse); the device work is one gather, bitwise op and scatter, or one
# sorted merge. Each returns a NEW tensor: request threads may still hold
# the resident one under its pre-write key, so it is never changed in place.
# ---------------------------------------------------------------------------

# one past the last legal column offset: sorts after every real entry of a
# sparse leaf (ops/hybrid.py)
SPARSE_SENTINEL = SHARD_WIDTH


def _member_in_sorted(vals: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Membership of vals[..., Kv] in sorted ref[..., Kr], elementwise bool:
    one binary probe per value (bitvector.py:292). Sentinel pads never
    match."""
    kr = ref.shape[-1]
    ref = ref if ref.is_contiguous() else ref.contiguous()
    vals_c = vals if vals.is_contiguous() else vals.contiguous()
    pos = torch.searchsorted(ref, vals_c).clamp_(max=kr - 1)
    hit = torch.gather(ref, -1, pos) == vals
    return hit & (vals < SPARSE_SENTINEL)


def patch_dense_words(plane: torch.Tensor, sidx, widx, set_mask,
                      clear_mask) -> torch.Tensor:
    """A patched copy of a dense row leaf int32[S, W]: at each (sidx[j],
    widx[j]) word, new = (old | set_mask[j]) & ~clear_mask[j]
    (bitvector.py:629). The four arguments are host arrays: indices, and
    masks as uint32 words (bit 31 included). Each coordinate must appear
    once (the caller reduces a batch per word first: with duplicates a
    scatter's result depends on write order on the card) and lie inside
    the plane. The JAX package pads to a static length with an
    out-of-range shard and lets the scatter drop it; torch has no dropping
    scatter (an out-of-range index raises on the CPU and is a device-side
    assert on CUDA), and needs no static shapes, so nothing is padded and
    both rules are checked here on the host. On a blocked leaf (a mesh)
    each block takes the coordinates of its own shards, at every
    position."""
    if isinstance(plane, Blocked):
        return _patch_blocks(plane, sidx, widx, set_mask, clear_mask)
    s, w = plane.shape
    sidx = np.asarray(sidx, dtype=np.int64).reshape(-1)
    widx = np.asarray(widx, dtype=np.int64).reshape(-1)
    smask = np.asarray(set_mask, dtype=np.uint32).reshape(-1)
    cmask = np.asarray(clear_mask, dtype=np.uint32).reshape(-1)
    if not sidx.size == widx.size == smask.size == cmask.size:
        raise ValueError("patch coordinates and masks differ in length")
    out = plane.clone()
    if not sidx.size:
        return out
    if (sidx.min() < 0 or sidx.max() >= s or widx.min() < 0
            or widx.max() >= w):
        raise IndexError(f"patch coordinate outside the [{s}, {w}] plane")
    if np.unique(sidx * w + widx).size != sidx.size:
        raise ValueError("patch coordinates repeat: reduce them per word")
    # one upload: the int32 views of the masks ride beside the indices
    host = np.stack([sidx, widx, smask.view(np.int32).astype(np.int64),
                     cmask.view(np.int32).astype(np.int64)])
    dev = torch.from_numpy(host).to(plane.device)
    si, wi = dev[0], dev[1]
    sm, cm = dev[2].to(torch.int32), dev[3].to(torch.int32)
    # ~ on the int32 view: torch's uint32 has no bitwise_not
    out[si, wi] = torch.bitwise_and(torch.bitwise_or(out[si, wi], sm),
                                    torch.bitwise_not(cm))
    return out


def _patch_blocks(plane: Blocked, sidx, widx, set_mask, clear_mask):
    """patch_dense_words of a blocked [S, W] leaf: the coordinates of slot
    j's shards, shifted to the block, patch slot j's block in every
    replica row."""
    sidx = np.asarray(sidx, dtype=np.int64).reshape(-1)
    widx = np.asarray(widx, dtype=np.int64).reshape(-1)
    smask = np.asarray(set_mask, dtype=np.uint32).reshape(-1)
    cmask = np.asarray(clear_mask, dtype=np.uint32).reshape(-1)
    if sidx.size and (sidx.min() < 0 or sidx.max() >= plane.length):
        raise IndexError("patch coordinate outside the blocked plane")
    per = plane.length // plane.n_slots
    out = []
    for row in plane.blocks:
        blocks = []
        for s, b in enumerate(row):
            sel = (sidx >= s * per) & (sidx < (s + 1) * per)
            blocks.append(patch_dense_words(b, sidx[sel] - s * per,
                                            widx[sel], smask[sel],
                                            cmask[sel]))
        out.append(blocks)
    return Blocked(out, plane.axis, plane.length)


def patch_sparse_rows(sp: torch.Tensor, adds, removes) -> torch.Tensor:
    """A patched copy of a sparse row leaf int32[S, K]: per shard, the
    sorted-dedup union of its entries and adds[S, A] minus removes[S, R]
    (both sorted and SPARSE_SENTINEL-padded, host arrays or tensors),
    re-padded to the same K slots (bitvector.py:645). The caller has
    checked that the patched row still fits K; otherwise it drops the leaf
    and the next read re-uploads it. On a blocked leaf (a mesh), adds and
    removes have a row per logical shard, pad shards included, and each
    block takes its own rows."""
    if isinstance(sp, Blocked):
        adds, removes = np.asarray(adds), np.asarray(removes)
        per = sp.length // sp.n_slots
        return Blocked(
            [[patch_sparse_rows(b, adds[s * per:(s + 1) * per],
                                removes[s * per:(s + 1) * per])
              for s, b in enumerate(row)] for row in sp.blocks],
            sp.axis, sp.length)
    k = sp.shape[-1]

    def on_device(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=sp.device, dtype=torch.int32)
        arr = np.ascontiguousarray(np.asarray(x, dtype=np.int32))
        return torch.from_numpy(arr).to(sp.device)

    adds, removes = on_device(adds), on_device(removes)
    srt = torch.sort(torch.cat([sp, adds], dim=-1), dim=-1).values
    edge = torch.full(srt.shape[:-1] + (1,), -1, dtype=srt.dtype,
                      device=srt.device)
    dup_prev = srt == torch.cat([edge, srt[..., :-1]], dim=-1)
    sentinel = torch.full_like(srt, SPARSE_SENTINEL)
    merged = torch.sort(torch.where(dup_prev, sentinel, srt), dim=-1).values
    keep = ~_member_in_sorted(merged, removes) & (merged < SPARSE_SENTINEL)
    out = torch.sort(torch.where(keep, merged, sentinel), dim=-1).values
    return out[..., :k].contiguous()


# ---------------------------------------------------------------------------
# Host <-> device conversion (numpy).
# ---------------------------------------------------------------------------


def dense_from_columns(columns: np.ndarray, width: int = SHARD_WIDTH) -> np.ndarray:
    """Pack column offsets (within one shard) into a dense little-endian
    uint32 bitvector of `width` bits."""
    if width % WORD_BITS:
        raise ValueError(f"width must be a multiple of {WORD_BITS}")
    bits = np.zeros(width, dtype=np.uint8)
    cols = np.asarray(columns, dtype=np.int64)
    if cols.size:
        if cols.min() < 0 or cols.max() >= width:
            raise ValueError("column offset out of shard range")
        bits[cols] = 1
    packed = np.packbits(bits, bitorder="little")
    return packed.view("<u4").copy()


def columns_from_planes(planes: torch.Tensor) -> list:
    """Inverse of dense_from_columns for each row of an [S, W] tensor of
    words: each row's set-bit positions as int64 offsets. The nonzero
    words are found where the tensor lies and only they go to the host: a
    Row result at 1024 shards is 32M words (128 MiB), and it holds a few
    thousand bits. A blocked tensor (a mesh) reads the first replica
    row's blocks in shard order, pad shards last."""
    if isinstance(planes, Blocked):
        return [cols for blk in planes.blocks[0]
                for cols in columns_from_planes(blk)]
    s, w = planes.shape
    flat = planes.reshape(-1)
    idx = torch.nonzero(flat).squeeze(1)  # ascending, as flatnonzero
    words = flat[idx].cpu().numpy()
    idx = idx.cpu().numpy()
    bits = np.unpackbits(words.view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")
    r, b = np.nonzero(bits)
    pos = idx[r] * 32 + b  # ascending: words in order, bits in order
    row_bits = w * 32
    edges = np.searchsorted(pos, np.arange(s + 1, dtype=np.int64) * row_bits)
    return [pos[edges[i]:edges[i + 1]] - i * row_bits for i in range(s)]
