"""Carry state across from the JAX package.

The index has no weights: its state is the planes on the device and the
fragments on disk, and both keep the reference's layout.

* planes_from_numpy / numpy_from_planes: uint32 planes <-> int32 tensors,
  bit for bit (the reference's jax arrays leave through numpy).
* hybrid_leaf_from_numpy: the reference's sparse and run leaves (int32
  column ids) -> int32 tensors, values unchanged.
* open_holder: open a data dir that pilosa_tpu.server.Server wrote (close
  that server first: fragments are flock'ed by their owner).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.device import (
    planes_to_tensor,
    resolve_device,
    tensor_to_planes,
)
from pilosa_tpu_torch.models.holder import Holder


def planes_from_numpy(words: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32 ndarray -> int32 tensor on `device`, bit-identical."""
    return planes_to_tensor(words, resolve_device(device))


def numpy_from_planes(planes: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 ndarray, bit-identical."""
    return tensor_to_planes(planes)


def hybrid_leaf_from_numpy(arr: np.ndarray, device="cuda") -> torch.Tensor:
    """A sparse ([S, K]) or run ([S, 2, R]) leaf of the JAX package, as
    numpy int32 column ids, -> the port's int32 tensor on `device`, values
    unchanged (the sentinel is 2^20 in both)."""
    arr = np.asarray(arr)
    if arr.dtype != np.int32 or arr.ndim not in (2, 3):
        raise ValueError(f"a sparse or run leaf is int32 [S, K] or "
                         f"[S, 2, R], got {arr.dtype} {arr.shape}")
    if arr.ndim == 3 and arr.shape[1] != 2:
        raise ValueError(f"a run leaf is [S, 2, R], got {arr.shape}")
    t = torch.from_numpy(np.ascontiguousarray(arr))
    dev = resolve_device(device)
    return t if dev.type == "cpu" else t.to(dev)


def open_holder(data_dir: str) -> Holder:
    """The holder of a data dir written by either package."""
    return Holder(data_dir).open()
