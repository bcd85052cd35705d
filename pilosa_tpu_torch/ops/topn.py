"""TopN ranking over candidate row leaves, on the topn_counts_packed kernel.

Port of pilosa_tpu/ops/topn.py (top_rows, top_rows_intersect,
tanimoto_counts_packed, tanimoto_mask). The rows are R [S, W] leaves (or
a stacked [R, S, W] slab), the src one [S, W] leaf; every count comes from
one kernel pass (ops/kernels.py topn_counts_packed) as int64. Ranking is a
stable sort, so equal counts keep slab order, as lax.top_k does.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import kernels


def _top_k(counts: torch.Tensor, k: int):
    """(counts, indices) of the k largest, ties in slab order."""
    vals, idx = torch.sort(counts, descending=True, stable=True)
    k = min(k, counts.shape[0])
    return vals[:k], idx[:k]


def top_rows(leaves, k: int):
    """(counts, indices) of the k highest-popcount leaves: the kernel with
    a zero src, as pallas_kernels.top_rows (:388) does; indices are slab
    positions."""
    packed = kernels.topn_counts_packed(leaves, torch.zeros_like(leaves[0]))
    return _top_k(packed[1], k)


def top_rows_intersect(leaves, src: torch.Tensor, k: int):
    """(counts, indices) of the k leaves with the largest |leaf & src|."""
    return _top_k(kernels.topn_counts_packed(leaves, src)[0], k)


def tanimoto_counts_packed(leaves, src: torch.Tensor) -> torch.Tensor:
    """int64[3, R]: |leaf & src|, |leaf|, |src| broadcast, in one pass."""
    return kernels.topn_counts_packed(leaves, src)


def tanimoto_mask(inter, rcounts, scount, threshold: int):
    """Keep-mask 100 * inter > threshold * (rcounts + scount - inter).
    Strict: a row whose tanimoto is exactly threshold / 100 is dropped, as
    in the reference (fragment.go:1096-1100)."""
    return 100 * inter > threshold * (rcounts + scount - inter)
