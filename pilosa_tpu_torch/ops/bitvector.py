"""Dense shard-bitvector algebra and popcounts in plain torch.

Trimmed port of pilosa_tpu/ops/bitvector.py:37-131 (dense algebra and
popcounts) plus numpy copies of its host conversions dense_from_columns /
columns_from_dense (:788, :803).

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


def band(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection: a & b."""
    return torch.bitwise_and(a, b)


def bor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union: a | b."""
    return torch.bitwise_or(a, b)


def bxor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric difference: a ^ b."""
    return torch.bitwise_xor(a, b)


def bandnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Difference: a &~ b."""
    return torch.bitwise_and(a, torch.bitwise_not(b))


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


def columns_from_dense(words: np.ndarray) -> np.ndarray:
    """Inverse of dense_from_columns: set-bit positions as int64 offsets."""
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.int64)
