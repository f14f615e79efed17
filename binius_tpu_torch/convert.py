"""Carry state between the JAX package and the port.

The JAX package holds words as uint32 numpy/JAX arrays; the port holds the
same bits as ``torch.int32``. These two functions cross over with the bits
unchanged, whatever the shape: P1 words, (N, 4) B128 limbs, (N, 8) digests.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve


def from_reference(arr: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with identical bits on `device`
    (CUDA unless named)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected uint32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(resolve(device))


def to_reference(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with identical bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected torch.int32, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
