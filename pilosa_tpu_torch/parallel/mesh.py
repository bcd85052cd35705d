"""Device runner: bitmap programs over resident [S, W] leaves, on one
device or over a replica x shard mesh.

Port of pilosa_tpu/parallel/mesh.py. The mesh (:36-188) is one process
over a list of torch devices: a 1-D ("shard",) or 2-D ("replica",
"shard") array of them, where one device may stand at several positions,
as XLA's virtual host devices all stand on one CPU (the JAX package's
tests run its mesh on 8 of them; a one-card machine stands a 2 x 4 mesh
on cuda:0). mesh_from_config serves the [mesh] keys devices, replicas and
host-devices by the JAX package's rules.

The DeviceRunner (:479-640) places every leaf as one block tensor per
mesh position (parallel/blocks.py Blocked): the shard axis padded to a
multiple of the shard slots (dense planes with zero, sparse and run
leaves with their sentinel, so a pad shard is empty in every form) and
cut into one block per slot, each replica row holding its own copy.
Programs are the nested tuples of :192-216:

    ("leaf", i) | ("not", p) | (op, p1, p2, ...), op in and/or/xor/andnot

"not" complements the full shard width, pad shards included; the
executor composes Not() as existence &~ child, and existence is empty on
pad shards. Rows are evaluated with plain torch bitwise ops per block, as
the reference leaves eval_row to XLA outside any Pallas kernel, and stay
blocked; counts go through the program_count kernel (intersect_count for
the 2-leaf AND form on one device), on a mesh through program_count_mesh,
and finish in int64.

The mesh serving forms (:250-476): eval_count_mesh and eval_row_mesh from
a per-mesh program cache with hit and miss counters (/debug/vars
iciProgramCache), the replica-scattered pair stream (scatter_queries,
pair_stream_counts) and the GroupBy chunk forms, whose per-block count
matrices are summed over the shard slots before the zero prune.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from pilosa_tpu_torch.device import planes_to_tensor, resolve_device
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitvector import (
    SPARSE_SENTINEL,
    chunk_count_matrix,
    groupby_chunk_live,
    groupby_chunk_matrix,
    live_from_matrix,
    total_count,
)
from pilosa_tpu_torch.parallel.blocks import Blocked, blockwise

SHARD_AXIS = "shard"
REPLICA_AXIS = "replica"

_AND2 = ("and", ("leaf", 0), ("leaf", 1))


class Mesh:
    """A named array of torch devices: `devices` is [shard] or [replica,
    shard]; `shape` maps each axis name to its size. Hashable by identity
    (the program cache keys on the mesh object, as jax.sharding.Mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def grid(self) -> list:
        """[replica][slot] devices (one replica row on a 1-D mesh)."""
        d = self.devices
        return [list(row) for row in (d if d.ndim == 2 else d[None])]

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devices})"


def _device_array(devices: Sequence) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr


def local_devices() -> list:
    """Every CUDA device of this process (jax.devices()'s role)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None, axis: str = SHARD_AXIS,
              replicas: int = 1) -> Mesh:
    """Mesh over the given devices (default: every local card); a device
    may repeat. replicas > 1 builds the 2-D ("replica", "shard") mesh:
    leaves shard over "shard" and every replica row holds a full copy,
    and a query stream splits over "replica" (pair_stream_counts)."""
    devices = list(devices) if devices is not None else local_devices()
    arr = _device_array(devices)
    if replicas > 1:
        if len(devices) % replicas:
            raise ValueError(
                f"{len(devices)} devices not divisible by {replicas} replicas")
        return Mesh(arr.reshape(replicas, -1), (REPLICA_AXIS, axis))
    return Mesh(arr, (axis,))


def group_by_slice(devices) -> list[list]:
    """Devices bucketed by slice (slice_index ascending); devices without
    a slice index, every torch device among them, land in one bucket."""
    buckets: dict = {}
    for d in devices:
        buckets.setdefault(getattr(d, "slice_index", 0), []).append(d)
    return [buckets[k] for k in sorted(buckets)]


def make_multislice_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """One replica per slice, shards within (pilosa_tpu/parallel/mesh.py
    :65-126); one slice, the only case a card has, is the plain 1-D
    shard mesh. Uneven slices are cut to the smallest, with a warning."""
    devices = list(devices) if devices is not None else local_devices()
    slices = group_by_slice(devices)
    if len(slices) <= 1:
        return make_mesh(devices)
    per = min(len(s) for s in slices)
    dropped = len(devices) - len(slices) * per
    if dropped:
        import warnings

        warnings.warn(
            f"multislice mesh: uneven slices truncated to {per} devices "
            f"each; {dropped} of {len(devices)} devices left idle")
    arr = _device_array([d for s in slices for d in s[:per]])
    return Mesh(arr.reshape(len(slices), per), (REPLICA_AXIS, SHARD_AXIS))


def _platform_devices(platform: str, host_devices: int) -> list:
    if platform == "cpu":
        return [torch.device("cpu")] * max(host_devices, 1)
    if platform in ("", "cuda", "gpu"):
        return local_devices()
    raise ValueError(f"[mesh] platform must be 'cpu', 'cuda' or empty, "
                     f"got {platform!r}")


def mesh_from_config(devices: str = "auto", platform: str = "",
                     host_devices: int = 0,
                     replicas: int = 1) -> Optional[Mesh]:
    """The server's mesh from its [mesh] keys (cli/config.py), by the
    rules of pilosa_tpu/parallel/mesh.py:156-188: host-devices = N > 0
    means platform cpu with N logical CPU devices; "none" gives None; an
    integer takes the first N devices and must lie in 1..available;
    fewer than 2 devices give None (the single-device runner); replicas =
    0 is one replica per slice (make_multislice_mesh)."""
    if host_devices > 0 and not platform:
        platform = "cpu"
    if devices == "none":
        return None
    avail = _platform_devices(platform, host_devices)
    if devices != "auto":
        try:
            n = int(devices)
        except ValueError:
            raise ValueError(
                f"[mesh] devices must be 'auto', 'none', or an integer "
                f"count, got {devices!r}")
        if n <= 0 or n > len(avail):
            raise ValueError(
                f"[mesh] devices = {n} out of range: {len(avail)} available")
        avail = avail[:n]
    if len(avail) < 2:
        return None
    if replicas == 0:
        return make_multislice_mesh(avail)
    return make_mesh(avail, replicas=max(replicas, 1))


# -- the mesh serving forms ------------------------------------------------
# eval_count_mesh / eval_row_mesh serve any bitmap program over blocked
# leaves from a per-mesh program cache keyed (kind, mesh, program,
# n_leaves) (:250-324): the port compiles nothing, so an entry is the
# program's checked per-block form, and the counters say how often a
# program shape came back, as the JAX package's say how often it was not
# recompiled.

_ici_programs: dict = {}
_ici_lock = threading.Lock()
_ici_stats = {"hits": 0, "misses": 0}


def ici_program_cache_stats() -> dict:
    with _ici_lock:
        return {"hits": _ici_stats["hits"], "misses": _ici_stats["misses"],
                "programs": len(_ici_programs)}


def _ici_cached(key, build):
    with _ici_lock:
        fn = _ici_programs.get(key)
        if fn is not None:
            _ici_stats["hits"] += 1
            return fn
    fn = build()
    with _ici_lock:
        _ici_stats["misses"] += 1
        return _ici_programs.setdefault(key, fn)


def _build_count_mesh(mesh: Mesh, program, n_leaves: int):
    kernels.encode_program(program)  # a malformed program fails here

    def run(leaves):
        return kernels.program_count_mesh(mesh, leaves, program)

    return run


def _build_row_mesh(mesh: Mesh, program, n_leaves: int):
    kernels.encode_program(program)

    def run(leaves):
        return kernels.eval_program_plain(list(leaves), program)

    return run


def eval_count_mesh(mesh: Mesh, leaves, program) -> int:
    """Blocked leaves -> total count: program_count_mesh (per-block
    kernel launches, the slot partials summed in int64)."""
    fn = _ici_cached(("count", mesh, program, len(leaves)),
                     lambda: _build_count_mesh(mesh, program, len(leaves)))
    return fn(list(leaves))


def eval_row_mesh(mesh: Mesh, leaves, program) -> Blocked:
    """Blocked leaves -> the blocked [S', W] result, every position
    computing its own block (never gathered)."""
    fn = _ici_cached(("row", mesh, program, len(leaves)),
                     lambda: _build_row_mesh(mesh, program, len(leaves)))
    return fn(list(leaves))


def scatter_queries(mesh: Mesh, ii, jj) -> tuple:
    """(parts, k): ii/jj padded with (0, 0) queries to a multiple of the
    replica count and cut into one contiguous part per replica row; k the
    real count (the padding's counts are dropped)."""
    return kernels.scatter_queries(mesh.shape.get(REPLICA_AXIS, 1), ii, jj)


def pair_stream_counts(mesh: Mesh, rows, ii, jj,
                       op: str = "and") -> np.ndarray:
    """Per-query counts of a stream of K op(Row i, Row j) queries on a
    replica x shard mesh -> host int64[K] (:369-427): each replica row
    counts its part of the queries against its own copy; the kernel is
    pair_stream_counts_mesh."""
    return kernels.pair_stream_counts_mesh(mesh, rows, ii, jj, op)


# -- GroupBy cross-count mesh forms (:429-476) -------------------------------
# Per-block [P, R] count matrices over each slot's shards, summed over the
# shard slots in int64; the zero prune runs on the summed matrix. Masked
# padding prefixes are zero on every block, so masking commutes with the
# sum.

_chunk_cmat_mesh = blockwise("sum")(chunk_count_matrix)


def groupby_chunk_live_mesh(mesh: Mesh, axis_slabs, idx, axis: Blocked,
                            n_valid: int, bound: int):
    """(n_live, flat_idx[bound], counts[bound]) of one level chunk over
    blocked slabs; device tensors, no host sync."""
    cmat = _chunk_cmat_mesh(list(axis_slabs), idx, axis, n_valid)
    return live_from_matrix(cmat, bound)


def groupby_chunk_matrix_mesh(mesh: Mesh, axis_slabs, idx, axis: Blocked,
                              n_valid: int) -> torch.Tensor:
    """The chunk's whole summed [chunk, R] count matrix."""
    return _chunk_cmat_mesh(list(axis_slabs), idx, axis, n_valid)


class DeviceRunner:
    """Executes bitmap programs over resident leaves, on one device or,
    with `mesh`, over blocked leaves at every mesh position.

    ici_serving ([cluster] ici-serving = off clears it through the
    server) routes a mesh's counts and rows through the program cache's
    forms; off, they run the same kernels uncached. Only meaningful with
    a mesh."""

    def __init__(self, device="cuda", mesh: Optional[Mesh] = None,
                 ici_serving: bool = True):
        self.mesh = mesh
        if mesh is not None:
            self.device = resolve_device(mesh.devices.flat[0])
            self._grid = [[resolve_device(d) for d in row]
                          for row in mesh.grid()]
            devices = {d for row in self._grid for d in row}
        else:
            self.device = resolve_device(device)
            devices = {self.device}
        self.ici_serving = bool(ici_serving) and mesh is not None
        for d in sorted(devices, key=str):
            if d.type == "cuda":
                self._self_check(d)

    @staticmethod
    def _self_check(device: torch.device) -> None:
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
        got = kernels.intersect_count(planes_to_tensor(a, device),
                                      planes_to_tensor(b, device))
        got = got.cpu().numpy()
        if not np.array_equal(got.astype(np.int64), want.astype(np.int64)):
            raise RuntimeError(
                f"intersect_count self-check failed on {device}: "
                f"kernel {got.tolist()} != expected {want.tolist()}")

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def n_shard_slots(self) -> int:
        """Positions along the shard axis: what leaf padding aligns to
        (the replica axis holds copies, not partitions)."""
        return 1 if self.mesh is None else self.mesh.shape[SHARD_AXIS]

    @property
    def n_replicas(self) -> int:
        return (1 if self.mesh is None
                else self.mesh.shape.get(REPLICA_AXIS, 1))

    @property
    def budget_scale(self) -> float:
        """Residency budget factor: leaves are charged one copy of their
        logical bytes, and a device holding k positions of an n-slot mesh
        holds k / n of that per byte."""
        if self.mesh is None:
            return 1.0
        per_dev: dict = {}
        for row in self._grid:
            for d in row:
                per_dev[d] = per_dev.get(d, 0) + 1
        return self.n_shard_slots / max(per_dev.values())

    def padded(self, n_shards: int) -> int:
        """The shard count a leaf over n_shards is placed with."""
        return n_shards + (-n_shards) % self.n_shard_slots

    def _put_shard_padded(self, arr: np.ndarray, shard_axis: int,
                          fill: int, planes: bool):
        """Pad `shard_axis` to a multiple of the shard slots with `fill`
        (:524-546) and place one block per mesh position, each its own
        allocation; planes go as int32 views of their uint32 words, index
        leaves by value."""
        pad = (-arr.shape[shard_axis]) % self.n_shard_slots
        if pad:
            widths = [(0, 0)] * arr.ndim
            widths[shard_axis] = (0, pad)
            arr = np.pad(arr, widths, constant_values=fill)
        parts = np.split(arr, self.n_shard_slots, axis=shard_axis)
        if planes:
            parts = [np.ascontiguousarray(p, dtype=np.uint32).view(np.int32)
                     for p in parts]
        else:
            parts = [np.ascontiguousarray(p) for p in parts]
        blocks = [[torch.from_numpy(parts[s]).to(dev, copy=True)
                   for s, dev in enumerate(row)] for row in self._grid]
        return Blocked(blocks, shard_axis, arr.shape[shard_axis])

    def put_leaf(self, rows: np.ndarray, fill: int = 0):
        """Place one uint32 [S, W] leaf as int32 planes: on a mesh, padded
        with `fill` and blocked (every replica row a full copy)."""
        if self.mesh is None:
            return planes_to_tensor(rows, self.device)
        return self._put_shard_padded(rows, 0, fill, planes=True)

    def put_index_leaf(self, arr: np.ndarray):
        """Place one sparse ([S, K]) or run ([S, 2, R]) leaf: int32 column
        ids, uploaded by value; on a mesh pad shards hold the sentinel
        (SPARSE_SENTINEL = RUN_SENTINEL), so they are empty."""
        if arr.dtype != np.int32:
            raise TypeError(f"index leaves are int32, got {arr.dtype}")
        if self.mesh is not None:
            return self._put_shard_padded(arr, 0, SPARSE_SENTINEL,
                                          planes=False)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t if self.device.type == "cpu" else t.to(self.device)

    def put_plane_slab(self, planes: np.ndarray):
        """Place one uint32 [D, S, W] BSI plane slab as int32 planes; on a
        mesh the shard axis (1) is padded with zero and blocked."""
        if planes.ndim != 3:
            raise ValueError(f"a plane slab is [D, S, W], got {planes.shape}")
        if self.mesh is None:
            return planes_to_tensor(planes, self.device)
        return self._put_shard_padded(planes, 1, 0, planes=True)

    def empty_slab(self, n_rows: int, n_shards: int, n_words: int):
        """An int32 [R, S, W] slab to fill row by row (set_slab_row): on a
        mesh blocked along S and zeroed, so pad shards stay empty."""
        if self.mesh is None:
            return torch.empty((n_rows, n_shards, n_words),
                               dtype=torch.int32, device=self.device)
        per = self.padded(n_shards) // self.n_shard_slots
        blocks = [[torch.zeros((n_rows, per, n_words), dtype=torch.int32,
                               device=dev) for dev in row]
                  for row in self._grid]
        return Blocked(blocks, 1, per * self.n_shard_slots)

    def set_slab_row(self, slab, i: int, src) -> None:
        """slab[i] = src: a resident [S, W] leaf (copied where it lies) or
        a host uint32 [S, W] array (len(shards) rows)."""
        if not isinstance(slab, Blocked):
            if isinstance(src, np.ndarray):
                src = planes_to_tensor(src, "cpu")
            slab[i].copy_(src)
            return
        if isinstance(src, np.ndarray):
            src = self.put_leaf(src)
        for r, s, blk in slab.positions():
            blk[i].copy_(src.blocks[r][s])

    def zeros_like_row(self, slab):
        """A zero [S, W] plane shaped as one row of `slab`."""
        if not isinstance(slab, Blocked):
            return torch.zeros_like(slab[0])
        return Blocked([[torch.zeros_like(b[0]) for b in row]
                        for row in slab.blocks], 0, slab.length)

    def row_leaves_dev(self, leaves: list, program):
        """Dense result [S, W] of `program`, left on the device(s): on a
        mesh blocked like its leaves."""
        if self.mesh is not None and self.ici_serving:
            return eval_row_mesh(self.mesh, list(leaves), program)
        return kernels.eval_program_plain(list(leaves), program)

    def count_total_leaves(self, leaves: list, program) -> int:
        """Total popcount of `program`. On a mesh: program_count_mesh, the
        pad shards' contributions zero (the executor masks Not() through
        existence, which is empty there); on one device the per-shard
        int32 counts of program_count (intersect_count for a 2-leaf AND)
        summed in int64 on the host."""
        leaves = list(leaves)
        if self.mesh is not None:
            if self.ici_serving:
                return eval_count_mesh(self.mesh, leaves, program)
            return kernels.program_count_mesh(self.mesh, leaves, program)
        if program == _AND2 and len(leaves) == 2:
            per_shard = kernels.intersect_count(leaves[0], leaves[1])
        else:
            per_shard = kernels.program_count(leaves, program)
        return total_count(per_shard)

    def groupby_chunk(self, axis_slabs, idx, axis, n_valid: int,
                      bound: int):
        """(n_live, flat_idx[bound], counts[bound]) device tensors of one
        GroupBy level chunk, through the cross_count_matrix kernel. Nothing
        is fetched: the executor enqueues a whole level first."""
        if self.mesh is not None:
            return groupby_chunk_live_mesh(self.mesh, axis_slabs, idx, axis,
                                           n_valid, bound)
        return groupby_chunk_live(axis_slabs, idx, axis, n_valid, bound,
                                  kernels.cross_count_matrix)

    def groupby_cmat(self, axis_slabs, idx, axis, n_valid: int):
        """The chunk's whole [chunk, R] count matrix (device tensor): the
        refetch when its live set overflows the pruning bound."""
        if self.mesh is not None:
            return groupby_chunk_matrix_mesh(self.mesh, axis_slabs, idx,
                                             axis, n_valid)
        return groupby_chunk_matrix(axis_slabs, idx, axis, n_valid,
                                    kernels.cross_count_matrix)
