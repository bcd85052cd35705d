"""Blocked tensors: one block per position of a replica x shard mesh.

The port's form of a jax.Array sharded P(..., "shard", ...) over a
("replica", "shard") mesh (pilosa_tpu/parallel/mesh.py): the shard axis,
padded to a multiple of the shard slots, is cut into equal contiguous
blocks, block j on shard slot j, and every replica row holds its own copy
of all of them. Each position has its own allocation, also where several
positions share one device (the JAX package's virtual host devices all
stand on one CPU; a one-card mesh stands all its positions on cuda:0).

`blockwise` is the shard_map of this port: a function of per-shard work
(every kernel wrapper, the BSI descents, the hybrid evaluator) runs on
each block as it runs on a whole tensor, and its results

  * stay blocked ("map": row results, one per position, every replica
    computing its own copy as GSPMD has every device compute its part),
  * are concatenated along their shard axis ("cat": per-shard counts,
    from the first replica row, which holds the whole shard axis), or
  * are summed over the shard slots in int64 ("sum": counts already
    reduced over the block's shards; the psum over "shard").

Called with no Blocked argument, a blockwise function is the function
itself: the single-device path is unchanged.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch


class Blocked:
    """A tensor of logical shape `shape` held as blocks[replica][slot],
    cut along dimension `axis` (of `length` shards, pad shards included)."""

    __slots__ = ("blocks", "axis", "length")

    def __init__(self, blocks, axis: int, length: int):
        self.blocks = tuple(tuple(row) for row in blocks)
        self.axis = axis
        self.length = length

    @property
    def n_replicas(self) -> int:
        return len(self.blocks)

    @property
    def n_slots(self) -> int:
        return len(self.blocks[0])

    @property
    def first(self) -> torch.Tensor:
        return self.blocks[0][0]

    @property
    def shape(self) -> torch.Size:
        s = list(self.first.shape)
        s[self.axis] = self.length
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.first.dtype

    @property
    def device(self) -> torch.device:
        return self.first.device

    @property
    def nbytes(self) -> int:
        """Bytes of one copy of the logical (padded) tensor: what a
        sharded jax.Array's nbytes gives, replicas not multiplied."""
        return math.prod(self.shape) * self.first.element_size()

    def dim(self) -> int:
        return self.first.dim()

    def positions(self):
        """(replica, slot, block) of every position."""
        for r, row in enumerate(self.blocks):
            for s, b in enumerate(row):
                yield r, s, b

    def storages(self) -> list:
        """(data pointer, bytes) of each block's memory."""
        out = []
        for _r, _s, b in self.positions():
            st = b.untyped_storage()
            out.append((st.data_ptr(), st.nbytes()))
        return out

    def gather(self, device=None) -> torch.Tensor:
        """The whole logical tensor from the first replica row, on
        `device` (default: the first block's)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in self.blocks[0]], dim=self.axis)

    def __repr__(self) -> str:
        return (f"Blocked(shape={tuple(self.shape)}, axis={self.axis}, "
                f"positions={self.n_replicas}x{self.n_slots}, "
                f"dtype={self.dtype})")


def is_blocked(x) -> bool:
    return isinstance(x, Blocked)


def _find(args, kwargs) -> "Blocked | None":
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, Blocked):
            return a
        if isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, Blocked):
                    return x
    return None


def _at(x, r: int, s: int):
    if isinstance(x, Blocked):
        return x.blocks[r][s]
    if isinstance(x, list) and any(isinstance(y, Blocked) for y in x):
        return [_at(y, r, s) for y in x]
    if isinstance(x, tuple) and any(isinstance(y, Blocked) for y in x):
        return tuple(_at(y, r, s) for y in x)
    return x


def _check_layout(ref: Blocked, args, kwargs) -> None:
    for a in list(args) + list(kwargs.values()):
        items = a if isinstance(a, (list, tuple)) else (a,)
        for x in items:
            if isinstance(x, Blocked) and (x.n_replicas, x.n_slots) != (
                    ref.n_replicas, ref.n_slots):
                raise ValueError(
                    f"blocked operands on different meshes: "
                    f"{x.n_replicas}x{x.n_slots} and "
                    f"{ref.n_replicas}x{ref.n_slots}")


def _rowcall(fn, r: int, n_slots: int, args, kwargs) -> list:
    return [fn(*[_at(a, r, s) for a in args],
               **{k: _at(v, r, s) for k, v in kwargs.items()})
            for s in range(n_slots)]


def _assemble(outs: list, axis: int):
    """Per-position results [replica][slot] -> Blocked (a tensor result) or
    a tuple of them (a tuple result; non-tensor items from position 0)."""
    first = outs[0][0]
    if isinstance(first, tuple):
        return tuple(_assemble([[o[i] for o in row] for row in outs], axis)
                     for i in range(len(first)))
    if not isinstance(first, torch.Tensor):
        return first
    length = sum(b.shape[axis] for b in outs[0])
    return Blocked(outs, axis, length)


def run_map(fn: Callable, axis: int, args, kwargs):
    ref = _find(args, kwargs)
    _check_layout(ref, args, kwargs)
    outs = [_rowcall(fn, r, ref.n_slots, args, kwargs)
            for r in range(ref.n_replicas)]
    return _assemble(outs, ref.axis if axis is None else axis)


def run_cat(fn: Callable, dim: int, args, kwargs) -> torch.Tensor:
    ref = _find(args, kwargs)
    _check_layout(ref, args, kwargs)
    parts = _rowcall(fn, 0, ref.n_slots, args, kwargs)
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def run_sum(fn: Callable, args, kwargs):
    ref = _find(args, kwargs)
    _check_layout(ref, args, kwargs)
    parts = _rowcall(fn, 0, ref.n_slots, args, kwargs)
    if not isinstance(parts[0], torch.Tensor):
        return sum(parts)
    dev = parts[0].device
    out = parts[0].to(torch.int64)
    for p in parts[1:]:
        out = out + p.to(device=dev, dtype=torch.int64)
    return out


def blockwise(mode: str, axis: "int | None" = 0):
    """Decorate a function of per-shard work so a Blocked argument (or a
    list of them) runs it per block: mode "map" (results blocked along
    `axis`, None: the first blocked argument's), "cat" (first replica
    row, concatenated along dimension `axis` of the results) or "sum"
    (first replica row, int64 sum)."""
    if mode not in ("map", "cat", "sum"):
        raise ValueError(f"unknown blockwise mode {mode!r}")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _find(args, kwargs) is None:
                return fn(*args, **kwargs)
            if mode == "map":
                return run_map(fn, axis, args, kwargs)
            if mode == "cat":
                return run_cat(fn, axis, args, kwargs)
            return run_sum(fn, args, kwargs)

        wrapper.local = fn  # the per-block function itself
        return wrapper

    return deco
