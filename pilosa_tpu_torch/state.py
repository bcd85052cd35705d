"""Carry state across from the JAX package.

The index has no weights: its state is the planes on the device and the
fragments on disk, and both keep the reference's layout.

* planes_from_numpy / numpy_from_planes: uint32 planes <-> int32 tensors,
  bit for bit (the reference's jax arrays leave through numpy).
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


def open_holder(data_dir: str) -> Holder:
    """The holder of a data dir written by either package."""
    return Holder(data_dir).open()
