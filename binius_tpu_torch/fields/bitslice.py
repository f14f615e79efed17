"""Bitsliced layout and gate network, plain PyTorch.

Bit ``b`` of 32 consecutive elements sits in one 32-bit word, so an element
batch becomes ``2^level`` bit planes. The transform in and out is five
masked-shift rounds per 32x32 bit block (Hacker's Delight 7-3). These are
the plain versions of K2 (`to_bitsliced`, `from_bitsliced`), of K1 (`mul`,
packed in and out, around the network `mul_planes`) and of the Karatsuba
network inside K3/K4; semantics are `binius_tpu/fields/bitslice.py`.
"""

from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# The same network on stacked plane tensors: the plain version of K1
# ---------------------------------------------------------------------------

def _mul_alpha_stacked(level: int, a: torch.Tensor) -> torch.Tensor:
    """`_mul_alpha_bs` on planes [..., 2^level, W]."""
    if level == 0:
        return a
    h = 1 << (level - 1)
    a0, a1 = a[..., :h, :], a[..., h:, :]
    return torch.cat([a1, a0 ^ _mul_alpha_stacked(level - 1, a1)], dim=-2)


def _mul_stacked(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_mul_bs` on planes [..., 2^level, W]: the three half products of each
    Karatsuba step stack on a new leading dim, so the 3^level base ANDs run
    as one tensor op instead of thousands of single-plane ops."""
    if level == 0:
        return a & b
    h = 1 << (level - 1)
    a0, a1 = a[..., :h, :], a[..., h:, :]
    b0, b1 = b[..., :h, :], b[..., h:, :]
    z = _mul_stacked(level - 1, torch.stack([a0, a1, a0 ^ a1]),
                     torch.stack([b0, b1, b0 ^ b1]))
    z0, z2, mid = z[0], z[1], z[2]
    lo = z0 ^ z2
    return torch.cat([lo, mid ^ lo ^ _mul_alpha_stacked(level - 1, z2)], dim=-2)


def mul_planes(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bitsliced multiply of planes [2^level, n_words] (either side may be
    [2^level, 1], broadcast over the words), gate for gate `_mul_bs`."""
    return _mul_stacked(level, a, b)


def _scalar_planes(level: int, x: torch.Tensor) -> torch.Tensor:
    """The planes [2^level, 1] of one element: every word of a batch of
    copies of x holds 0 or all ones in plane b, as bit b of x."""
    bits = torch.arange(32, dtype=torch.int32, device=x.device)
    return -((x.reshape(-1, 1) >> bits) & 1).reshape(-1, 1)[:1 << level]


def mul(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise tower product at level 5..7, packed in and out: the
    plain version of K1 (`bitslice_cuda.mul`),
    from_bitsliced(mul_planes(to_bitsliced(a), to_bitsliced(b))). Batch
    shapes broadcast; an operand of one element enters as its scalar planes,
    and a batch that is not a multiple of 32 is zero-padded (zero words
    absorb in the network)."""
    batch = torch.broadcast_shapes(tower.batch_shape(level, a), tower.batch_shape(level, b))
    shape = tower.elem_shape(level, batch)
    n = math.prod(batch)
    if n == 0:
        return torch.zeros(shape, dtype=torch.int32, device=a.device)
    pad = -n % 32

    def planes(x):
        if n > 1 and math.prod(tower.batch_shape(level, x)) == 1:
            return _scalar_planes(level, x)
        x = x.expand(shape).reshape(tower.elem_shape(level, (n,)))
        if pad:
            x = torch.cat([x, x.new_zeros(tower.elem_shape(level, (pad,)))])
        return to_bitsliced(level, x)

    return from_bitsliced(level, mul_planes(level, planes(a), planes(b)))[:n].reshape(shape)
