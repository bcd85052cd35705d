"""Device runner: bitmap programs over HBM-resident [S, W] leaves.

Trimmed port of pilosa_tpu/parallel/mesh.py: the single-device
DeviceRunner (put_leaf / put_plane_slab / row_leaves_dev /
count_total_leaves, :479-611; groupby_chunk / groupby_cmat, :613-640, on
one device with no psum; put_index_leaf for sparse and run leaves) and
the nested-tuple programs of :192-216:

    ("leaf", i) | ("not", p) | (op, p1, p2, ...), op in and/or/xor/andnot

"not" complements the full shard width; the executor composes Not() as
existence &~ child. Rows are evaluated with plain torch bitwise ops, as the
reference leaves eval_row to XLA outside any Pallas kernel; counts go
through the program_count kernel (intersect_count for the 2-leaf AND form)
and finish in int64 on the host. On one device there are no pad shards.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.device import planes_to_tensor, resolve_device
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitvector import (
    groupby_chunk_live,
    groupby_chunk_matrix,
    total_count,
)

_AND2 = ("and", ("leaf", 0), ("leaf", 1))


class DeviceRunner:
    """Executes bitmap programs over resident leaves on one device."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            self._self_check()

    def _self_check(self) -> None:
        """Run intersect_count on a small known input and raise on a
        mismatch: a broken kernel build fails at server start, loudly,
        not at the first query (the port's pallas_kernels.available())."""
        rng = np.random.default_rng(0)
        a = rng.integers(0, 2**32, size=(3, 64), dtype=np.uint64)
        b = rng.integers(0, 2**32, size=(3, 64), dtype=np.uint64)
        a, b = a.astype(np.uint32), b.astype(np.uint32)
        a[0, :8] = 0xFFFFFFFF
        b[0, :8] = 0xFFFFFFFF
        a[1, :8] = 0x80000000
        b[1, :8] = 0x80000000
        want = np.unpackbits((a & b).view(np.uint8), axis=1).sum(axis=1)
        got = kernels.intersect_count(planes_to_tensor(a, self.device),
                                      planes_to_tensor(b, self.device))
        got = got.cpu().numpy()
        if not np.array_equal(got.astype(np.int64), want.astype(np.int64)):
            raise RuntimeError(
                f"intersect_count self-check failed on {self.device}: "
                f"kernel {got.tolist()} != expected {want.tolist()}")

    def put_leaf(self, rows: np.ndarray) -> torch.Tensor:
        """Place one uint32 [S, W] leaf on the device as int32 planes."""
        return planes_to_tensor(rows, self.device)

    def put_index_leaf(self, arr: np.ndarray) -> torch.Tensor:
        """Place one sparse ([S, K]) or run ([S, 2, R]) leaf on the device:
        int32 column ids, uploaded by value (they are ids, not planes)."""
        if arr.dtype != np.int32:
            raise TypeError(f"index leaves are int32, got {arr.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t if self.device.type == "cpu" else t.to(self.device)

    def put_plane_slab(self, planes: np.ndarray) -> torch.Tensor:
        """Place one uint32 [D, S, W] BSI plane slab on the device as
        int32 planes (one device: no pad shards)."""
        if planes.ndim != 3:
            raise ValueError(f"a plane slab is [D, S, W], got {planes.shape}")
        return planes_to_tensor(planes, self.device)

    def row_leaves_dev(self, leaves: list, program) -> torch.Tensor:
        """Dense result [S, W] of `program`, left on the device."""
        return kernels.eval_program_plain(list(leaves), program)

    def count_total_leaves(self, leaves: list, program) -> int:
        """Total popcount of `program`: per-shard int32 counts from the
        kernels, summed in int64 on the host."""
        leaves = list(leaves)
        if program == _AND2 and len(leaves) == 2:
            per_shard = kernels.intersect_count(leaves[0], leaves[1])
        else:
            per_shard = kernels.program_count(leaves, program)
        return total_count(per_shard)

    def groupby_chunk(self, axis_slabs, idx, axis: torch.Tensor,
                      n_valid: int, bound: int):
        """(n_live, flat_idx[bound], counts[bound]) device tensors of one
        GroupBy level chunk, through the cross_count_matrix kernel. Nothing
        is fetched: the executor enqueues a whole level first."""
        return groupby_chunk_live(axis_slabs, idx, axis, n_valid, bound,
                                  kernels.cross_count_matrix)

    def groupby_cmat(self, axis_slabs, idx, axis: torch.Tensor,
                     n_valid: int) -> torch.Tensor:
        """The chunk's whole [chunk, R] count matrix (device tensor): the
        refetch when its live set overflows the pruning bound."""
        return groupby_chunk_matrix(axis_slabs, idx, axis, n_valid,
                                    kernels.cross_count_matrix)
