"""Device choice and the uint32 <-> int32 plane views.

Planes live on the device as int32 tensors that are bit-identical views of
the reference's uint32 words (bit p at word p >> 5, bit p & 31): torch's
uint32 dtype lacks bitwise_not and >>, and int32 has both. Conversions are
reinterpretations, never value casts.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`: "cuda" (the default everywhere) or "cpu".

    Asking for cuda on a machine without a card raises: the port never
    quietly runs on the CPU. Only the tests pass device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def planes_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 ndarray -> int32 tensor on `device`, bit for bit."""
    arr = np.ascontiguousarray(words, dtype=np.uint32)
    t = torch.from_numpy(arr.view(np.int32))
    dev = torch.device(device)
    return t if dev.type == "cpu" else t.to(dev)


def tensor_to_planes(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> uint32 ndarray, bit for bit."""
    if t.dtype != torch.int32:
        raise TypeError(f"planes are int32 tensors, got {t.dtype}")
    return t.detach().contiguous().cpu().numpy().view(np.uint32)
