"""Device choice and the int32 word helpers shared by the port.

Words are held as ``torch.int32`` with the same bits as the JAX package's
uint32 (torch on the CPU has no uint32 shifts). Two consequences:
``>>`` is arithmetic, so a logical right shift masks (`shr`), and a
constant >= 2^31 is written as its negative int32 (`i32`).
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a card, asking for CUDA raises; nothing moves to the
    CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "binius_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' for the plain PyTorch path")
    return dev


def i32(v: int) -> int:
    """uint32 bit pattern -> the int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words by a constant 0 < k < 32."""
    return (x >> k) & ((1 << (32 - k)) - 1)
