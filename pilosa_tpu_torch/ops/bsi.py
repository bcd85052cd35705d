"""Bit-sliced integer (BSI) operations over a [D, S, W] plane slab.

Trimmed port of pilosa_tpu/ops/bsi.py. An int field stores value - min in
D bit planes (plane 0 the least significant) plus a not-null row; planes
are int32 [D, S, W] bit views on the device.

* ``compare``: the lt/lte/gt/gte/eq/neq sweep -> [S, W] match mask, through
  the bsi_compare kernel (ops/kernels.py; bsi.py:172-189). Sum's
  per-plane counts come straight from the bsi_sum_counts kernel.
* ``bsi_min_packed`` / ``bsi_max_packed``: the greedy high-to-low bit
  descent (bsi.py:64-121). The JAX package leaves it to XLA; here each
  step's per-shard "any zero / any one" count comes from the hand kernels
  (program_count over ("andnot", cand, plane) for Min, intersect_count for
  Max) and its keep decision is a torch.where on the device: no host sync
  per plane, one fetch of the packed [D+1, S] result at the end.
* ``bsi_min_max_batched``: the same descent for K candidate masks at once
  (the MinMaxBatcher's; pilosa_tpu/parallel/batcher.py _batched_min_max,
  :607-615, a vmap of the single descent). Each plane costs one
  bsi_sum_counts launch over the contiguous view planes[i:i+1] with the K
  candidates as its filters: row 0 of its int32[K, 2, S] is |plane & cand|
  per shard (Max's "any one"), row 1 is |cand|, so row 1 - row 0 > 0 is
  Min's "any zero". One more launch after the last step counts the
  attaining columns: D + 1 launches for the batch, against K x (D + 1)
  one query at a time.

The host finishes every total exactly: ``counts_to_sum`` builds a Python
int from per-plane counts (bsi.py:197-211).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitvector as bv
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel.blocks import blockwise

LT, LTE, GT, GTE, EQ, NEQ = kernels.BSI_OPS

_ANDNOT2 = ("andnot", ("leaf", 0), ("leaf", 1))
_LEAF0 = ("leaf", 0)


def compare(planes: torch.Tensor, exists: torch.Tensor, pred_bits,
            op: str) -> torch.Tensor:
    """[S, W] mask of the columns of `exists` whose stored value `op` the
    predicate given as per-plane bits (LSB first), one bit per plane.
    BETWEEN is composed by the caller as GTE(a) & LTE(b)."""
    return kernels.bsi_compare(planes, exists, pred_bits, op)


def _descent(planes: torch.Tensor, candidate: torch.Tensor,
             is_min: bool) -> torch.Tensor:
    depth = planes.shape[0]
    bits = [None] * depth
    for i in range(depth - 1, -1, -1):
        plane = planes[i]
        if is_min:
            # shards where a candidate has a 0 here keep only those
            has = kernels.program_count([candidate, plane], _ANDNOT2) > 0
            keep = has[:, None]
            candidate = torch.where(keep, bv.bandnot(candidate, plane),
                                    bv.band(candidate, plane))
            bits[i] = (~has).to(torch.int32)
        else:
            # shards where a candidate has a 1 here keep only those
            has = kernels.intersect_count(candidate, plane) > 0
            keep = has[:, None]
            candidate = torch.where(keep, bv.band(candidate, plane),
                                    bv.bandnot(candidate, plane))
            bits[i] = has.to(torch.int32)
    count = kernels.program_count([candidate], _LEAF0)
    return torch.stack(bits + [count])


@blockwise("cat", -1)
def bsi_min_packed(planes: torch.Tensor, candidate: torch.Tensor) -> torch.Tensor:
    """int32[D+1, S]: per shard the bits of the least stored value among
    `candidate` (exists & filter) in rows 0..D-1, and how many columns
    attain it in row D (0 where the shard has no candidate)."""
    return _descent(planes, candidate, is_min=True)


@blockwise("cat", -1)
def bsi_max_packed(planes: torch.Tensor, candidate: torch.Tensor) -> torch.Tensor:
    """Mirror of bsi_min_packed for the greatest stored value."""
    return _descent(planes, candidate, is_min=False)


# ---------------------------------------------------------------------------
# Host-side helpers of the exact-integer protocol.
# ---------------------------------------------------------------------------


def value_to_bits(value: int, depth: int) -> np.ndarray:
    """Split a non-negative int into per-plane 0/1 bits (LSB first)."""
    if value < 0:
        raise ValueError("BSI stored values are offsets from the field min; "
                         "must be >= 0")
    return np.array([(value >> i) & 1 for i in range(depth)], dtype=np.int32)


def bits_to_value(bits) -> int:
    """Assemble a Python int from per-plane bits (LSB first)."""
    return sum((int(b) & 1) << i
               for i, b in enumerate(np.asarray(bits).tolist()))


def counts_to_sum(counts) -> int:
    """sum of 2^i * counts[i] as an exact Python int."""
    return sum(int(c) << i for i, c in enumerate(np.asarray(counts).tolist()))


# ---------------------------------------------------------------------------
# The batched descent (the MinMaxBatcher's)
# ---------------------------------------------------------------------------


def _batched_descent(planes: torch.Tensor, candidates, is_min: bool,
                     sum_counts) -> torch.Tensor:
    depth, s, _ = planes.shape
    cand = torch.stack(list(candidates))  # [K, S, W], updated in place
    k = cand.shape[0]
    out = torch.empty((k, depth + 1, s), dtype=torch.int32,
                      device=planes.device)
    for i in range(depth - 1, -1, -1):
        counts = sum_counts(planes[i:i + 1], list(cand.unbind(0)))
        ones = counts[:, 0]  # |plane & cand| per (query, shard)
        if is_min:
            # any zero here: keep the zeros (cand &~ plane), bit 0
            has = counts[:, 1] - ones > 0
            out[:, i] = (~has).to(torch.int32)
            flip = -has.to(torch.int32)
        else:
            # any one here: keep the ones (cand & plane), bit 1
            has = ones > 0
            out[:, i] = has.to(torch.int32)
            flip = has.to(torch.int32) - 1
        # plane where it keeps the ones, ~plane where it keeps the zeros
        cand.bitwise_and_(torch.bitwise_xor(planes[i][None],
                                            flip[:, :, None]))
    out[:, depth] = sum_counts(planes[:1], list(cand.unbind(0)))[:, 1]
    return out


@blockwise("cat", -1)
def bsi_min_max_batched(planes: torch.Tensor, candidates,
                        is_min: bool) -> torch.Tensor:
    """int32[K, D+1, S]: bsi_min_packed (is_min) or bsi_max_packed of each
    of K [S, W] candidate masks over one [D, S, W] slab, their counts from
    D + 1 bsi_sum_counts launches in all."""
    return _batched_descent(planes, candidates, is_min,
                            kernels.bsi_sum_counts)


@blockwise("cat", -1)
def bsi_min_max_batched_plain(planes: torch.Tensor, candidates,
                              is_min: bool) -> torch.Tensor:
    """bsi_min_max_batched with its counts in plain torch on any device
    (kernels.bsi_sum_counts_plain): what the card checks the kernel route
    against."""
    return _batched_descent(planes, candidates, is_min,
                            kernels.bsi_sum_counts_plain)
