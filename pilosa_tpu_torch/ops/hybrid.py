"""Sparse and run row leaves, and mixed-tree evaluation, in plain torch.

Port of pilosa_tpu/ops/bitvector.py:281-616 (the sparse and run kernel
families, which the JAX package leaves to XLA outside any Pallas kernel)
and :663-780 (eval_hybrid, hybrid_count).

Three representations of a row over S shards:

* dense: int32[S, W], the bit view of the uint32 planes (ops/bitvector.py);
* sparse: int32[S, K], sorted shard-local column ids padded with
  SPARSE_SENTINEL (K slots of 4 bytes instead of a 128 KiB plane);
* run: int32[S, 2, R], sorted disjoint non-adjacent inclusive intervals,
  [:, 0, :] starts and [:, 1, :] lasts, padded with RUN_SENTINEL starts
  (the validity test is start < RUN_SENTINEL; lasts of pad slots are never
  read as data).

Every op returns the sorted sentinel-padded layout, bit-identical to the
JAX function of the same name, so compositions chain. The sparse∩dense
node is the one place a kernel plugs in: eval_hybrid's `sparse_dense_fn`
(and `sparse_diff_dense_fn`) take ops/kernels.py sparse_intersect_dense
(and sparse_difference_dense) on the card; the functions here are their
plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.constants import WORD_BITS, WORDS_PER_SHARD
from pilosa_tpu_torch.ops import bitvector as bv
# SPARSE_SENTINEL is one past the last legal column offset: it sorts after
# every real entry; its word index (SHARD_WIDTH >> 5) is one past the last
# dense word
from pilosa_tpu_torch.ops.bitvector import (
    SPARSE_SENTINEL,
    _member_in_sorted,
)

# sparse ∪ sparse keeps Ka + Kb slots; past this eval_hybrid densifies
SPARSE_UNION_CAP = 1 << 14

# shared with the sparse form: one past the last legal column offset
RUN_SENTINEL = SPARSE_SENTINEL

_INT32_WRAP = 1 << 32


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - _INT32_WRAP, x).to(torch.int32)


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_contiguous() else x.contiguous()


# ---------------------------------------------------------------------------
# Sparse rows
# ---------------------------------------------------------------------------


def _resort(vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Mask non-kept entries to the sentinel and restore sorted order."""
    masked = torch.where(keep, vals, torch.full_like(vals, SPARSE_SENTINEL))
    return torch.sort(masked, dim=-1).values


def sparse_count(sp: torch.Tensor) -> torch.Tensor:
    """Set bits of a sparse row: entries below the sentinel -> int32[...]."""
    return (sp < SPARSE_SENTINEL).sum(dim=-1, dtype=torch.int32)


def sparse_intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sparse ∩ sparse -> sparse[..., min(Ka, Kb)]: the smaller operand's
    values probed into the larger."""
    if a.shape[-1] > b.shape[-1]:
        a, b = b, a
    return _resort(a, _member_in_sorted(a, b))


def sparse_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sparse &~ sparse -> sparse[..., Ka]."""
    keep = ~_member_in_sorted(a, b) & (a < SPARSE_SENTINEL)
    return _resort(a, keep)


def _dense_bit_test(sp: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """For each sparse entry, its bit in the dense operand (int32 words:
    the bit is taken after the shift, so the arithmetic >> is harmless).
    Sentinel slots test the last real bit and are masked out."""
    safe = sp.clamp(max=SPARSE_SENTINEL - 1).to(torch.int64)
    w = torch.gather(dense, -1, safe >> 5)
    bit = (w >> (safe & 31).to(torch.int32)) & 1
    return (bit != 0) & (sp < SPARSE_SENTINEL)


def sparse_intersect_dense(sp: torch.Tensor,
                           dense: torch.Tensor) -> torch.Tensor:
    """sparse ∩ dense -> sparse[..., K] by gather-and-test (the plain
    version of the ops/kernels.py kernel)."""
    return _resort(sp, _dense_bit_test(sp, dense))


def sparse_difference_dense(sp: torch.Tensor,
                            dense: torch.Tensor) -> torch.Tensor:
    """sparse &~ dense -> sparse[..., K]."""
    keep = ~_dense_bit_test(sp, dense) & (sp < SPARSE_SENTINEL)
    return _resort(sp, keep)


def sparse_dense_count(sp: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """popcount(sparse ∩ dense) -> int32[...] without the intersection."""
    return _dense_bit_test(sp, dense).sum(dim=-1, dtype=torch.int32)


def _merge_sorted(a: torch.Tensor, b: torch.Tensor):
    """(merged[..., Ka+Kb], dup_prev, dup_next): sorted concatenation and
    its adjacent-duplicate masks (a value in both operands is one adjacent
    pair: the inputs are sorted and unique per row)."""
    srt = torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
    edge = torch.full(srt.shape[:-1] + (1,), -1, dtype=srt.dtype,
                      device=srt.device)
    dup_prev = srt == torch.cat([edge, srt[..., :-1]], dim=-1)
    dup_next = srt == torch.cat([srt[..., 1:], edge], dim=-1)
    return srt, dup_prev, dup_next


def sparse_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sparse ∪ sparse -> sparse[..., Ka+Kb]."""
    srt, dup_prev, _ = _merge_sorted(a, b)
    return _resort(srt, ~dup_prev & (srt < SPARSE_SENTINEL))


def sparse_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sparse ^ sparse -> sparse[..., Ka+Kb]."""
    srt, dup_prev, dup_next = _merge_sorted(a, b)
    return _resort(srt, ~dup_prev & ~dup_next & (srt < SPARSE_SENTINEL))


def sparse_to_dense(sp: torch.Tensor,
                    n_words: int = WORDS_PER_SHARD) -> torch.Tensor:
    """sparse[..., K] -> dense int32[..., n_words]. Each entry's bit is
    built in int64 (1 << 31 does not fit a positive int32) and wrapped to
    int32; entries are unique, so the per-word scatter-add adds distinct
    bits without carries and equals an OR. Sentinel slots (and entries past
    n_words) add 0 to word 0: the JAX package's mode="drop"."""
    lead, k = sp.shape[:-1], sp.shape[-1]
    flat = sp.reshape(-1, k).to(torch.int64)
    word = flat >> 5
    live = (flat < SPARSE_SENTINEL) & (word < n_words)
    bits = _wrap_int32(torch.where(live, 1 << (flat & 31), 0))
    out = torch.zeros((flat.shape[0], n_words), dtype=torch.int32,
                      device=sp.device)
    out.scatter_add_(1, torch.where(live, word, 0), bits)
    return out.reshape(*lead, n_words)


def sparse_from_columns(columns: np.ndarray, slots: int) -> np.ndarray:
    """Sorted shard-local offsets -> one padded sparse row int32[slots]."""
    out = np.full(slots, SPARSE_SENTINEL, dtype=np.int32)
    cols = np.sort(np.asarray(columns, dtype=np.int64))
    n = min(cols.size, slots)
    out[:n] = cols[:n]
    return out


# ---------------------------------------------------------------------------
# Run rows
# ---------------------------------------------------------------------------


def _runs_contain(starts: torch.Tensor, lasts: torch.Tensor,
                  vals: torch.Tensor):
    """(contains, containing_last): for each vals[..., K] point, whether it
    lies in one of the sorted disjoint runs [starts, lasts][..., R], and
    that run's inclusive last. One binary probe per point."""
    starts, lasts = _contiguous(starts), _contiguous(lasts)
    pos = torch.searchsorted(starts, _contiguous(vals), right=True)
    idx = (pos - 1).clamp_(min=0)
    s = torch.gather(starts, -1, idx)
    last = torch.gather(lasts, -1, idx)
    contains = ((pos > 0) & (vals >= s) & (vals <= last)
                & (s < RUN_SENTINEL) & (vals < RUN_SENTINEL))
    return contains, last


def run_count(runs: torch.Tensor) -> torch.Tensor:
    """Set bits of a run row: the sum of its interval lengths -> int32."""
    starts, lasts = runs[..., 0, :], runs[..., 1, :]
    length = torch.where(starts < RUN_SENTINEL, lasts - starts + 1, 0)
    return length.sum(dim=-1, dtype=torch.int32)


def _run_overlaps(a: torch.Tensor, b: torch.Tensor):
    """(cand, ok, end_min): each overlap of two run rows starts at one of
    the operands' starts, so the merged starts are probed once into both;
    ok marks real overlap starts, end_min their inclusive ends."""
    sa, la = a[..., 0, :], a[..., 1, :]
    sb, lb = b[..., 0, :], b[..., 1, :]
    cand = torch.sort(torch.cat([sa, sb], dim=-1), dim=-1).values
    in_a, end_a = _runs_contain(sa, la, cand)
    in_b, end_b = _runs_contain(sb, lb, cand)
    # a start shared by both operands emits its overlap twice: keep one
    edge = torch.full(cand.shape[:-1] + (1,), -1, dtype=cand.dtype,
                      device=cand.device)
    dup = cand == torch.cat([edge, cand[..., :-1]], dim=-1)
    ok = in_a & in_b & ~dup & (cand < RUN_SENTINEL)
    return cand, ok, torch.minimum(end_a, end_b)


def run_intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """run ∩ run -> run[..., 2, Ra+Rb] by interval merge, re-sorted."""
    cand, ok, end_min = _run_overlaps(a, b)
    sent = torch.full_like(cand, RUN_SENTINEL)
    starts = torch.where(ok, cand, sent)
    lasts = torch.where(ok, end_min, sent)
    order = torch.argsort(starts, dim=-1, stable=True)
    return torch.stack([torch.gather(starts, -1, order),
                        torch.gather(lasts, -1, order)], dim=-2)


def run_intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|run ∩ run| -> int32[...]: the overlap lengths, never sorted."""
    cand, ok, end_min = _run_overlaps(a, b)
    length = torch.where(ok, end_min - cand + 1, 0)
    return length.sum(dim=-1, dtype=torch.int32)


def sparse_intersect_run(sp: torch.Tensor, runs: torch.Tensor) -> torch.Tensor:
    """sparse ∩ run -> sparse[..., K]: one containment probe per entry."""
    contains, _ = _runs_contain(runs[..., 0, :], runs[..., 1, :], sp)
    return _resort(sp, contains)


def sparse_difference_run(sp: torch.Tensor,
                          runs: torch.Tensor) -> torch.Tensor:
    """sparse &~ run -> sparse[..., K]."""
    contains, _ = _runs_contain(runs[..., 0, :], runs[..., 1, :], sp)
    return _resort(sp, ~contains & (sp < SPARSE_SENTINEL))


def _bit_span(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 mask of bits lo..hi (0 <= lo <= hi <= 31) of a word."""
    return ((1 << (hi + 1)) - 1) ^ ((1 << lo) - 1)


def run_to_dense(runs: torch.Tensor,
                 n_words: int = WORDS_PER_SHARD) -> torch.Tensor:
    """run[..., 2, R] -> dense int32[..., n_words], built word by word:
    the words strictly inside a run are all ones (a word-level difference
    array and its prefix sum, [.., n_words + 1] int32), its first and last
    words get partial masks through one scatter-add. Runs are disjoint, so
    no word takes two masks that share a bit and the add equals an OR.
    Bits past n_words * 32 are dropped, as the JAX diff-array form drops
    them. Equal bit for bit to the JAX run_to_dense, without its
    per-bit cumsum over 2^20 + 1 lanes."""
    width = n_words * WORD_BITS
    lead, r = runs.shape[:-2], runs.shape[-1]
    s = runs[..., 0, :].reshape(-1, r).to(torch.int64)
    last = runs[..., 1, :].reshape(-1, r).to(torch.int64)
    valid = (s < RUN_SENTINEL) & (s < width)
    last = torch.minimum(last, torch.full_like(last, width - 1))
    ws, wl = s >> 5, last >> 5
    zero = torch.zeros_like(s)
    # interior words ws+1 .. wl-1: +1 at ws+1, -1 at wl
    inner = valid & (wl > ws + 1)
    diff = torch.zeros((s.shape[0], n_words + 1), dtype=torch.int32,
                       device=runs.device)
    one = inner.to(torch.int32)
    diff.scatter_add_(1, torch.where(inner, ws + 1, zero), one)
    diff.scatter_add_(1, torch.where(inner, wl, zero), -one)
    words = torch.where(torch.cumsum(diff[:, :n_words], dim=1,
                                     dtype=torch.int32) > 0, -1, 0)
    words = words.to(torch.int32)
    # head word: bits s&31 .. (l&31 if the run ends there, else 31)
    same = wl == ws
    head_hi = torch.where(same, last & 31, torch.full_like(last, 31))
    head = torch.where(valid, _bit_span(s & 31, head_hi), zero)
    words.scatter_add_(1, torch.where(valid, ws, zero), _wrap_int32(head))
    # tail word of a run spanning two or more words: bits 0 .. l&31
    tail_live = valid & ~same
    tail = torch.where(tail_live, _bit_span(zero, last & 31), zero)
    words.scatter_add_(1, torch.where(tail_live, wl, zero), _wrap_int32(tail))
    return words.reshape(*lead, n_words)


def run_intersect_dense(runs: torch.Tensor, dense: torch.Tensor,
                        n_words: int = WORDS_PER_SHARD) -> torch.Tensor:
    """run ∩ dense -> dense int32[..., n_words]."""
    return bv.band(run_to_dense(runs, n_words), dense)


def run_dense_count(runs: torch.Tensor, dense: torch.Tensor,
                    n_words: int = WORDS_PER_SHARD) -> torch.Tensor:
    """popcount(run ∩ dense) -> int32[...]."""
    return bv.popcount(run_intersect_dense(runs, dense, n_words))


def intervals_from_sorted(cols: np.ndarray) -> np.ndarray:
    """Sorted unique offsets -> int64[n, 2] inclusive [start, last] rows."""
    if cols.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    breaks = np.flatnonzero(np.diff(cols) != 1)
    starts = np.concatenate([cols[:1], cols[breaks + 1]])
    lasts = np.concatenate([cols[breaks], cols[-1:]])
    return np.stack([starts, lasts], axis=1)


def runs_from_intervals(intervals: np.ndarray, slots: int) -> np.ndarray:
    """[n, 2] inclusive intervals -> one padded run row int32[2, slots]
    (intervals past `slots` are dropped)."""
    out = np.full((2, slots), RUN_SENTINEL, dtype=np.int32)
    iv = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    n = min(iv.shape[0], slots)
    out[0, :n] = iv[:n, 0]
    out[1, :n] = iv[:n, 1]
    return out


def runs_from_columns(columns: np.ndarray, slots: int) -> np.ndarray:
    """Shard-local offsets -> one padded run row int32[2, slots]."""
    cols = np.sort(np.asarray(columns, dtype=np.int64))
    if cols.size == 0:
        return np.full((2, slots), RUN_SENTINEL, dtype=np.int32)
    return runs_from_intervals(intervals_from_sorted(cols), slots)


# ---------------------------------------------------------------------------
# Mixed trees
# ---------------------------------------------------------------------------


def eval_hybrid(program, leaves: list, kinds: list,
                n_words: int = WORDS_PER_SHARD, sparse_dense_fn=None,
                sparse_diff_dense_fn=None):
    """Evaluate a nested-tuple program over mixed dense/sparse/run leaves
    -> (kind, tensor), by the JAX package's rules: intersections keep the
    cheapest faithful form (sparse∩* sparse, run∩run run, run∩dense
    dense), differences keep a sparse left operand sparse, unions and
    xors of two sparse rows stay sparse up to SPARSE_UNION_CAP slots, and
    everything else (Not, run operands of unions, wide unions)
    materializes planes. `sparse_dense_fn` and `sparse_diff_dense_fn` take
    the sparse∩dense and sparse&~dense nodes (the kernel wrappers on the
    card); both default to the plain versions here."""
    sd = sparse_dense_fn or sparse_intersect_dense
    sdd = sparse_diff_dense_fn or sparse_difference_dense

    def dense_of(kind, arr):
        if kind == "sparse":
            return sparse_to_dense(arr, n_words)
        if kind == "run":
            return run_to_dense(arr, n_words)
        return arr

    def ev(p):
        op = p[0]
        if op == "leaf":
            return kinds[p[1]], leaves[p[1]]
        if op == "not":
            k, a = ev(p[1])
            return "dense", bv.bnot(dense_of(k, a))
        k, acc = ev(p[1])
        for q in p[2:]:
            k2, x = ev(q)
            if op == "and":
                if k == "sparse" and k2 == "sparse":
                    acc = sparse_intersect(acc, x)
                elif k == "sparse" and k2 == "run":
                    acc = sparse_intersect_run(acc, x)
                elif k == "run" and k2 == "sparse":
                    acc, k = sparse_intersect_run(x, acc), "sparse"
                elif k == "run" and k2 == "run":
                    acc = run_intersect(acc, x)
                elif k == "sparse":
                    acc = sd(acc, x)
                elif k2 == "sparse":
                    acc, k = sd(x, acc), "sparse"
                elif k == "run":
                    acc, k = run_intersect_dense(acc, x, n_words), "dense"
                elif k2 == "run":
                    acc = run_intersect_dense(x, acc, n_words)
                else:
                    acc = bv.band(acc, x)
            elif op == "andnot":
                if k == "sparse" and k2 == "sparse":
                    acc = sparse_difference(acc, x)
                elif k == "sparse" and k2 == "run":
                    acc = sparse_difference_run(acc, x)
                elif k == "sparse":
                    acc = sdd(acc, x)
                else:
                    acc = bv.bandnot(dense_of(k, acc), dense_of(k2, x))
                    k = "dense"
            elif op in ("or", "xor"):
                if (k == "sparse" and k2 == "sparse"
                        and acc.shape[-1] + x.shape[-1] <= SPARSE_UNION_CAP):
                    acc = (sparse_union if op == "or" else sparse_xor)(acc, x)
                else:
                    acc = (bv.bor if op == "or" else bv.bxor)(
                        dense_of(k, acc), dense_of(k2, x))
                    k = "dense"
            else:
                raise ValueError(f"unknown op {op!r}")
        return k, acc

    return ev(program)


def hybrid_count(program, leaves: list, kinds: list,
                 n_words: int = WORDS_PER_SHARD, sparse_dense_fn=None,
                 sparse_diff_dense_fn=None) -> int:
    """Total count of a mixed program: a sparse root counts its live
    slots, a run root sums interval lengths, a dense root popcounts; the
    per-shard int32 counts finish in int64 on the host. An AND of run
    leaves only folds with run_intersect and ends with the fused
    run_intersect_count, never sorting the last overlap list."""
    if (isinstance(program, tuple) and program[0] == "and"
            and len(program) >= 3
            and all(isinstance(q, tuple) and q[0] == "leaf"
                    and kinds[q[1]] == "run" for q in program[1:])):
        ops = [leaves[q[1]] for q in program[1:]]
        acc = ops[0]
        for x in ops[1:-1]:
            acc = run_intersect(acc, x)
        per_shard = run_intersect_count(acc, ops[-1])
    else:
        kind, arr = eval_hybrid(program, leaves, kinds, n_words,
                                sparse_dense_fn, sparse_diff_dense_fn)
        if kind == "sparse":
            per_shard = sparse_count(arr)
        elif kind == "run":
            per_shard = run_count(arr)
        else:
            per_shard = bv.popcount(arr)
    return bv.total_count(per_shard)
