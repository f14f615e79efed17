"""Bitsliced layout and gate network, plain PyTorch.

Bit ``b`` of 32 consecutive elements sits in one 32-bit word, so an element
batch becomes ``2^level`` bit planes. The transform in and out is five
masked-shift rounds per 32x32 bit block (Hacker's Delight 7-3). These are
the plain versions of K2 (`bitslice_cuda.transpose32`) and of the
Karatsuba network inside K3/K4; semantics are `binius_tpu/fields/bitslice.py`.
"""

from __future__ import annotations

import torch

from ..device import i32, shr
from . import tower

_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def _transpose32(m: torch.Tensor) -> torch.Tensor:
    """Bit-transpose each 32x32 block: m [..., 32, W] -> t [..., 32, W] with
    t[..., b, w] bit j == m[..., j, w] bit b."""
    for mask, j in zip(_MASKS, (16, 8, 4, 2, 1)):
        r = m.reshape(*m.shape[:-2], -1, 2, j, m.shape[-1])
        lo, hi = r[..., 0, :, :], r[..., 1, :, :]
        t = (lo ^ (hi << j)) & i32(~mask)
        m = torch.stack([lo ^ t, hi ^ shr(t, j)], dim=-3).reshape(m.shape)
    return m


def to_bitsliced(level: int, a: torch.Tensor) -> torch.Tensor:
    """Canonical layout [N(, limbs)] -> bit planes [2^level, N/32]; N must be
    a multiple of 32."""
    nb = 1 << level
    if not tower.has_limb_dim(level):
        a = a[..., None]
    n = a.shape[0]
    assert n % 32 == 0, n
    limbs = a.shape[-1]
    m = a.reshape(n // 32, 32, limbs).permute(2, 1, 0)  # [limbs, 32, N/32]
    return _transpose32(m).reshape(limbs * 32, n // 32)[:nb]


def from_bitsliced(level: int, planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bitsliced`."""
    nb = 1 << level
    nw = planes.shape[1]
    limbs = max(1, nb // 32)
    if nb < 32:
        planes = torch.cat([planes, planes.new_zeros((32 - nb, nw))], dim=0)
    t = _transpose32(planes.reshape(limbs, 32, nw))
    out = t.permute(2, 1, 0).reshape(nw * 32, limbs)
    if not tower.has_limb_dim(level):
        out = out[..., 0]
        if level < 5:
            out = out & ((1 << nb) - 1)
    return out


# ---------------------------------------------------------------------------
# The gate network on lists of planes (any tensors with ^ and &)
# ---------------------------------------------------------------------------

def _xor(a: list, b: list) -> list:
    return [x ^ y for x, y in zip(a, b)]


def _mul_alpha_bs(level: int, a: list) -> list:
    """Multiply by X_level."""
    if level == 0:
        return a
    h = 1 << (level - 1)
    a0, a1 = a[:h], a[h:]
    return a1 + _xor(a0, _mul_alpha_bs(level - 1, a1))


def _mul_bs(level: int, a: list, b: list) -> list:
    """Karatsuba to the 1-bit base case: z0^z2 low, z1 ^ alpha*z2 high."""
    if level == 0:
        return [a[0] & b[0]]
    h = 1 << (level - 1)
    a0, a1 = a[:h], a[h:]
    b0, b1 = b[:h], b[h:]
    z0 = _mul_bs(level - 1, a0, b0)
    z2 = _mul_bs(level - 1, a1, b1)
    mid = _mul_bs(level - 1, _xor(a0, a1), _xor(b0, b1))
    z1 = _xor(mid, _xor(z0, z2))
    return _xor(z0, z2) + _xor(z1, _mul_alpha_bs(level - 1, z2))
