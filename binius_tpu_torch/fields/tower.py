"""Layout of binary tower field elements on torch tensors.

The layout is the JAX package's (`binius_tpu/fields/tower.py`):

  * level 0..5 (B1..B32): one element per 32-bit lane, value in the low
    ``2^level`` bits;
  * level 6 (B64) and 7 (B128): a trailing dim of 2 or 4 little-endian
    32-bit limbs;
  * P1: bit-packed B1 words, 32 coefficients per word, LSB first.

Words are ``torch.int32`` holding the uint32 bits (see `device.py`).
Only the layout subset lives here: construction, conversion, addition,
subfield joins and the P1 helpers. Multiplication waits for K1.
"""

from __future__ import annotations

import numpy as np
import torch


def n_limbs(level: int) -> int:
    """32-bit limbs in the trailing dim (1 for level <= 5: no trailing dim)."""
    return 1 if level <= 5 else 1 << (level - 5)


def has_limb_dim(level: int) -> bool:
    return level >= 6


def elem_shape(level: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    return (*shape, n_limbs(level)) if has_limb_dim(level) else tuple(shape)


def zeros(level: int, shape: tuple[int, ...], device=None) -> torch.Tensor:
    return torch.zeros(elem_shape(level, shape), dtype=torch.int32, device=device)


def from_numpy(level: int, arr: np.ndarray, device=None) -> torch.Tensor:
    """uint32 (level <= 5), uint64 (level 6) or (..., n_limbs) uint32 numpy
    -> int32 tensor in the canonical layout."""
    arr = np.asarray(arr)
    if level <= 5:
        arr = arr.astype(np.uint32)
    elif arr.dtype == np.uint64 and level == 6:
        arr = np.stack([(arr & 0xFFFFFFFF).astype(np.uint32),
                        (arr >> np.uint64(32)).astype(np.uint32)], axis=-1)
    assert arr.dtype == np.uint32, arr.dtype
    assert level <= 5 or arr.shape[-1] == n_limbs(level), arr.shape
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32).copy()).to(device)


def to_ints(level: int, a: torch.Tensor) -> list[int]:
    arr = a.detach().cpu().contiguous().numpy().view(np.uint32)
    if not has_limb_dim(level):
        return [int(x) for x in arr.reshape(-1)]
    flat = arr.reshape(-1, n_limbs(level)).astype(np.uint64)
    out = flat[:, 0].astype(object)
    for k in range(1, n_limbs(level)):
        out = out | (flat[:, k].astype(object) << (32 * k))
    return [int(x) for x in out]


def add(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    del level
    return a ^ b


def xor_reduce(a: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR (field sum) along `dim` as a halving tree of elementwise XORs
    (torch has no XOR reduction)."""
    dim = dim % a.ndim
    n = a.shape[dim]
    if n == 0:
        return torch.zeros(a.shape[:dim] + a.shape[dim + 1:], dtype=a.dtype, device=a.device)
    p = 1 << (n - 1).bit_length()
    if p != n:  # zero padding is the XOR identity
        pad = list(a.shape)
        pad[dim] = p - n
        a = torch.cat([a, a.new_zeros(pad)], dim=dim)
    while p > 1:
        p //= 2
        a = a.narrow(dim, 0, p) ^ a.narrow(dim, p, p)
    return a.squeeze(dim)


def join_from_subfield(level: int, sub_level: int, coeffs: torch.Tensor) -> torch.Tensor:
    """coeffs (..., 2^(level - sub_level)) T_sub_level coefficients over the
    subfield basis -> T_level elements (`tower.join_from_subfield`)."""
    if level == sub_level:
        return coeffs[..., 0] if not has_limb_dim(level) else coeffs[..., 0, :]
    sb = 1 << sub_level
    if level <= 5:
        shifts = torch.arange(coeffs.shape[-1], dtype=torch.int32, device=coeffs.device) * sb
        return xor_reduce(coeffs << shifts, -1)
    L = n_limbs(level)
    if sb >= 32:
        return coeffs if sub_level <= 5 else coeffs.reshape(*coeffs.shape[:-2], L)
    per_limb = 32 // sb
    parts = coeffs.reshape(*coeffs.shape[:-1], L, per_limb)
    shifts = torch.arange(per_limb, dtype=torch.int32, device=coeffs.device) * sb
    return xor_reduce(parts << shifts, -1)


# ---------------------------------------------------------------------------
# B1 packed-bit columns (32 bits per word), the witness storage layout
# ---------------------------------------------------------------------------

P1 = -1
P1_MIN_VARS = 7


def unpack_b1(packed: torch.Tensor) -> torch.Tensor:
    """int32[N] words -> int32[32*N] of 0/1 elements (LSB first)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    out = (packed[..., None] >> shifts) & 1
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 32)


def pack_b1(bits_arr: torch.Tensor) -> torch.Tensor:
    """int32[32*N] of 0/1 -> packed int32[N] (LSB first)."""
    n = bits_arr.shape[-1] // 32
    parts = bits_arr.reshape(*bits_arr.shape[:-1], n, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=bits_arr.device)
    return xor_reduce((parts & 1) << shifts, -1)


def p1_n_elems(level: int, data: torch.Tensor) -> int:
    """Element count of a witness array, packed or not."""
    return data.shape[0] * 32 if level == P1 else data.shape[0]


def resolve_p1(level: int, data: torch.Tensor):
    """(P1, words) -> (0, unpacked 0/1 lanes); identity otherwise."""
    if level == P1:
        return 0, unpack_b1(data)
    return level, data


def maybe_pack_b1(level: int, data: torch.Tensor):
    """Bit-pack level-0 columns large enough to be worth it; identity otherwise."""
    if (level == 0 and data.ndim == 1 and data.shape[0] >= (1 << P1_MIN_VARS)
            and data.shape[0] % 32 == 0):
        return P1, pack_b1(data)
    return level, data

