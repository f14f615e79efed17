"""K1 and K2: the bitsliced tower multiply and the 32x32 bit transpose on
the card, and the element-wise multiply built from them.

Counterpart of `binius_tpu/fields/bitslice_pallas.py` (`mul_planes`,
`transpose32`, `to_bitsliced`, `from_bitsliced`, `mul`). K2
(`csrc/transpose32.cu`) takes element strides, so the (N, limbs) <->
[limbs, 32, N/32] relayout is folded into its loads and stores. K1
(`csrc/tower_mul.cu`) runs the Karatsuba gate network on planes at levels
5..7. On a CPU tensor each wrapper takes the plain version in `bitslice`;
on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math

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


def mul_planes(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: element-wise product of bit planes [2^level, W] at level 5..7
    (bitslice.mul_planes)."""
    if not a.is_cuda:
        return bitslice.mul_planes(level, a, b)
    if not 5 <= level <= 7:
        raise ValueError(f"mul_planes: level {level} is not 5..7")
    for t, name in ((a, "mul_planes a"), (b, "mul_planes b")):
        cuda_lib.check(t, name, ndim=2)
        if t.shape[0] != 1 << level:
            raise ValueError(f"{name}: expected {1 << level} planes, got {tuple(t.shape)}")
    if a.shape != b.shape:
        raise ValueError(f"mul_planes: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    out = torch.empty_like(a)
    if a.shape[1]:
        cuda_lib.call("k1_tower_mul", a.data_ptr(), b.data_ptr(), out.data_ptr(), level,
                      a.shape[1])
    return out


def mul(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise tower product at level 5..7 as `bitslice_pallas.mul`
    computes it: both operands to bit planes (K2), the network (K1), back
    (K2). Batch shapes broadcast (a scalar operand is copied out to the
    batch); the batch is zero-padded to a multiple of 32 elements, and zero
    words are absorbing for the network."""
    batch = torch.broadcast_shapes(tower.batch_shape(level, a), tower.batch_shape(level, b))
    shape = tower.elem_shape(level, batch)
    n = math.prod(batch)
    if n == 0:
        return a.new_zeros(shape)
    flat = tower.elem_shape(level, (n,))
    ops = [x.expand(shape).reshape(flat) for x in (a, b)]
    pad = -n % 32
    if pad:
        ops = [torch.cat([x, x.new_zeros(tower.elem_shape(level, (pad,)))]) for x in ops]
    planes = mul_planes(level, to_bitsliced(level, ops[0].contiguous()),
                        to_bitsliced(level, ops[1].contiguous()))
    out = from_bitsliced(level, planes)
    return out[:n].reshape(shape)
