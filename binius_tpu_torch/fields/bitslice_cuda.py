"""K2: the 32x32 bit transpose on the card, and the bitsliced layout on top.

Counterpart of `binius_tpu/fields/bitslice_pallas.py` (`transpose32`,
`to_bitsliced`, `from_bitsliced`). The kernel (`csrc/transpose32.cu`)
takes element strides, so the (N, limbs) <-> [limbs, 32, N/32] relayout
is folded into its loads and stores. On a CPU tensor each wrapper takes the
plain version in `bitslice`; on a CUDA tensor it launches K2 or raises.
"""

from __future__ import annotations

import torch

from .. import cuda_lib
from . import bitslice, tower


def _launch(src: torch.Tensor, dst: torch.Tensor, groups: int, n_words: int,
            src_strides: tuple, dst_strides: tuple) -> None:
    cuda_lib.call("k2_transpose32", src.data_ptr(), dst.data_ptr(), groups, n_words,
                  *src_strides, *dst_strides)


def transpose32(m: torch.Tensor) -> torch.Tensor:
    """Bit-transpose each 32x32 block of m [G, 32, W] (bitslice._transpose32)."""
    if not m.is_cuda:
        return bitslice._transpose32(m)
    cuda_lib.check(m, "transpose32", ndim=3)
    groups, rows, n_words = m.shape
    if rows != 32:
        raise ValueError(f"transpose32: expected [G, 32, W], got {tuple(m.shape)}")
    out = torch.empty_like(m)
    strides = (32 * n_words, n_words, 1)
    _launch(m, out, groups, n_words, strides, strides)
    return out


def to_bitsliced(level: int, a: torch.Tensor) -> torch.Tensor:
    """[N(, limbs)] -> planes [2^level, N/32] (bitslice.to_bitsliced)."""
    if not a.is_cuda:
        return bitslice.to_bitsliced(level, a)
    cuda_lib.check(a, "to_bitsliced", ndim=2 if tower.has_limb_dim(level) else 1)
    limbs = tower.n_limbs(level)
    n = a.shape[0]
    if n % 32 or (tower.has_limb_dim(level) and a.shape[1] != limbs):
        raise ValueError(f"to_bitsliced: bad shape {tuple(a.shape)} for level {level}")
    W = n // 32
    planes = torch.empty((limbs * 32, W), dtype=torch.int32, device=a.device)
    # source (g, j, w) = a[32w + j, g]; destination (g, b, w) = planes[32g + b, w]
    _launch(a, planes, limbs, W, (1, limbs, 32 * limbs), (32 * W, W, 1))
    return planes[:1 << level]


def from_bitsliced(level: int, planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bitsliced`."""
    if not planes.is_cuda:
        return bitslice.from_bitsliced(level, planes)
    cuda_lib.check(planes, "from_bitsliced", ndim=2)
    nb = 1 << level
    if planes.shape[0] != nb:
        raise ValueError(f"from_bitsliced: expected {nb} planes, got {planes.shape[0]}")
    W = planes.shape[1]
    if nb < 32:
        planes = torch.cat([planes, planes.new_zeros((32 - nb, W))])
    limbs = tower.n_limbs(level)
    out = torch.empty((W * 32, limbs), dtype=torch.int32, device=planes.device)
    _launch(planes, out, limbs, W, (32 * W, W, 1), (1, limbs, 32 * limbs))
    if not tower.has_limb_dim(level):
        out = out.view(-1)
        if level < 5:
            out = out & ((1 << nb) - 1)
    return out
