"""Shard placement: 256 partitions, fnv64a keys, jump consistent hashing.

Copy of pilosa_tpu/parallel/placement.py (the reference's cluster.go:
828-913): partition = fnv64a(index name || big-endian 64-bit shard) mod
the partition count; the partition's primary node is jump_hash(partition,
len(nodes)) over the nodes in id order, and the next replica_n - 1 nodes
around the ring hold its copies. The hash is the JAX package's bit for
bit, so a cluster of port nodes and JAX nodes agrees on every owner.
"""

from __future__ import annotations

from pilosa_tpu_torch.constants import DEFAULT_PARTITION_N

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv64a(data: bytes) -> int:
    h = _FNV64_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _MASK64
    return h


def partition(index: str, shard: int,
              partition_n: int = DEFAULT_PARTITION_N) -> int:
    """(index, shard) -> partition id (cluster.go:828)."""
    return fnv64a(index.encode() + shard.to_bytes(8, "big")) % partition_n


def jump_hash(key: int, n: int) -> int:
    """Jump consistent hash: key -> bucket in [0, n) (Lamping & Veach;
    cluster.go:902-913)."""
    key &= _MASK64
    b, j = -1, 0
    while j < n:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK64
        j = int((b + 1) * ((1 << 31) / ((key >> 33) + 1)))
    return b


class ModHasher:
    """key % n: deterministic placement for tests."""

    def hash(self, key: int, n: int) -> int:
        return key % n


class JmpHasher:
    def hash(self, key: int, n: int) -> int:
        return jump_hash(key, n)
