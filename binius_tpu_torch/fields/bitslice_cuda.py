"""K1 and K2 on the card: the packed tower multiply and the packed <-> bit
plane relayout.

Counterparts of `binius_tpu/fields/bitslice_pallas.py`: `mul` is its
`mul` (`from_bitsliced . mul_planes . to_bitsliced`) as one launch of K1
(`csrc/tower_mul.cu`), packed in and packed out; `to_bitsliced` and
`from_bitsliced` are its functions of the same names, one launch of K2
(`csrc/transpose32.cu`) each, which the NTT's packed entry runs around
K3/K4. On CPU tensors each function takes its plain version in
`bitslice`; on CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import math

import torch

from .. import cuda_lib
from . import bitslice, tower

# B128 products of at least this many elements run K1's persistent kernel
# (`mul128_kernel`: one block per SM looping over tiles, the next tiles'
# loads and transposes overlapping the network); smaller ones run one block
# per tile (`mul_kernel<7>`), which has no pipeline to fill. Set from the
# device time of each at the opening's sizes (scripts/profile_opening.py
# --k1-designs, on an H100).
B128_PERSISTENT_FROM = 1 << 20


def _packed(x: torch.Tensor, align: int) -> torch.Tensor:
    """x, contiguous and aligned to its element's vector access."""
    if not x.is_contiguous() or x.data_ptr() % align:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def to_bitsliced(level: int, a: torch.Tensor) -> torch.Tensor:
    """[N(, limbs)] -> planes [2^level, N/32] (bitslice.to_bitsliced)."""
    if not a.is_cuda:
        return bitslice.to_bitsliced(level, a)
    limbs = tower.n_limbs(level)
    a = _packed(a, 4 * limbs)
    cuda_lib.check(a, "to_bitsliced", ndim=2 if tower.has_limb_dim(level) else 1, align=4 * limbs)
    n = a.shape[0]
    if n % 32 or n == 0 or (tower.has_limb_dim(level) and a.shape[1] != limbs):
        raise ValueError(f"to_bitsliced: bad shape {tuple(a.shape)} for level {level}")
    W = n // 32
    planes = torch.empty((limbs * 32, W), dtype=torch.int32, device=a.device)
    cuda_lib.call("k2_transpose32", a.data_ptr(), planes.data_ptr(), limbs, W, 1)
    return planes[:1 << level]


def from_bitsliced(level: int, planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bitsliced`."""
    if not planes.is_cuda:
        return bitslice.from_bitsliced(level, planes)
    cuda_lib.check(planes, "from_bitsliced", ndim=2, align=4)
    nb = 1 << level
    if planes.shape[0] != nb or planes.shape[1] == 0:
        raise ValueError(f"from_bitsliced: expected {nb} planes of words, got "
                         f"{tuple(planes.shape)}")
    W = planes.shape[1]
    if nb < 32:
        planes = torch.cat([planes, planes.new_zeros((32 - nb, W))])
    limbs = tower.n_limbs(level)
    out = torch.empty((W * 32, limbs), dtype=torch.int32, device=planes.device)
    cuda_lib.call("k2_transpose32", planes.data_ptr(), out.data_ptr(), limbs, W, 0)
    if not tower.has_limb_dim(level):
        out = out.view(-1)
        if level < 5:
            out = out & ((1 << nb) - 1)
    return out


def mul(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: element-wise tower product at level 5..7, packed in and packed
    out, in one launch (bitslice.mul). Batch shapes broadcast: an operand
    of one element is read in place as a scalar; other broadcasts are
    copied out to the batch. Any batch length is taken as it is."""
    if not (a.is_cuda or b.is_cuda):
        return bitslice.mul(level, a, b)
    if not 5 <= level <= 7:
        raise ValueError(f"mul: level {level} is not 5..7")
    batch = torch.broadcast_shapes(tower.batch_shape(level, a), tower.batch_shape(level, b))
    shape = tower.elem_shape(level, batch)
    n = math.prod(batch)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    ops, scalar = [], []
    for x, name in ((a, "mul a"), (b, "mul b")):
        one = math.prod(tower.batch_shape(level, x)) == 1
        align = 4 if one else 4 * tower.n_limbs(level)
        x = _packed(x if one else x.expand(shape), align)
        cuda_lib.check(x, name, align=align)
        ops.append(x)
        scalar.append(int(one))
    persistent = int(level == 7 and n >= B128_PERSISTENT_FROM)
    cuda_lib.call("k1_tower_mul", ops[0].data_ptr(), ops[1].data_ptr(), out.data_ptr(), level, n,
                  *scalar, persistent)
    return out
