"""Binary tower field operations on torch tensors.

The layout is the JAX package's (`binius_tpu/fields/tower.py`):

  * level 0..5 (B1..B32): one element per 32-bit lane, value in the low
    ``2^level`` bits;
  * level 6 (B64) and 7 (B128): a trailing dim of 2 or 4 little-endian
    32-bit limbs;
  * P1: bit-packed B1 words, 32 coefficients per word, LSB first.

Words are ``torch.int32`` holding the uint32 bits (see `device.py`).

Multiplication: levels <= 3 gather from the B8 table; level 4 is one
Karatsuba step over B8 products (`fastmul.mul_collect`'s gather
semantics); levels 5..7 go through `bitslice_cuda.mul` (one K1 launch on
packed data on the card, its plain version `bitslice.mul` for CPU
tensors). Operand shapes broadcast.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import shr
from . import scalar


def n_limbs(level: int) -> int:
    """32-bit limbs in the trailing dim (1 for level <= 5: no trailing dim)."""
    return 1 if level <= 5 else 1 << (level - 5)


def has_limb_dim(level: int) -> bool:
    return level >= 6


def elem_shape(level: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    return (*shape, n_limbs(level)) if has_limb_dim(level) else tuple(shape)


def batch_shape(level: int, a: torch.Tensor) -> tuple[int, ...]:
    """Shape of the element batch (without the limb dim)."""
    return tuple(a.shape[:-1]) if has_limb_dim(level) else tuple(a.shape)


def zeros(level: int, shape: tuple[int, ...], device=None) -> torch.Tensor:
    return torch.zeros(elem_shape(level, shape), dtype=torch.int32, device=device)


def _int_to_limbs(level: int, v: int) -> np.ndarray:
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(n_limbs(level))],
                    dtype=np.uint32)


def full(level: int, shape: tuple[int, ...], value: int, device=None) -> torch.Tensor:
    """A batch of `shape` copies of the element `value`."""
    limbs = torch.from_numpy(_int_to_limbs(level, value).view(np.int32).copy()).to(device)
    if has_limb_dim(level):
        return limbs.expand(*shape, n_limbs(level)).contiguous()
    return limbs[0].expand(shape).contiguous()


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


def from_ints(level: int, values, device=None) -> torch.Tensor:
    """Python ints -> tensor in the canonical layout on `device`."""
    vals = [int(v) for v in values]
    out = np.zeros((len(vals), n_limbs(level)), dtype=np.uint32)
    for k in range(n_limbs(level)):
        out[:, k] = [(v >> (32 * k)) & 0xFFFFFFFF for v in vals]
    return from_numpy(level, out if has_limb_dim(level) else out[:, 0], device)


def to_ints(level: int, a: torch.Tensor) -> list[int]:
    arr = a.detach().cpu().contiguous().numpy().view(np.uint32)
    if not has_limb_dim(level):
        return [int(x) for x in arr.reshape(-1)]
    flat = arr.reshape(-1, n_limbs(level)).astype(np.uint64)
    out = flat[:, 0].astype(object)
    for k in range(1, n_limbs(level)):
        out = out | (flat[:, k].astype(object) << (32 * k))
    return [int(x) for x in out]


# ---------------------------------------------------------------------------
# Addition = XOR
# ---------------------------------------------------------------------------

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


def sum_elems(level: int, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Field sum of a batch of elements along a batch axis."""
    if has_limb_dim(level) and axis < 0:
        axis -= 1  # keep the limb dim out of the reduction
    return xor_reduce(a, axis)


# ---------------------------------------------------------------------------
# B8 base case: 64 KB gather tables, cached per device
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        arr = {"mul": scalar.b8_mul_table, "square": scalar.b8_square_table,
               "invert": scalar.b8_invert_table}[name]()
        _TABLES[key] = torch.from_numpy(arr.astype(np.int32)).to(device)
    return _TABLES[key]


def _mul_b8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: int32 lanes holding values < 256 (shapes broadcast)."""
    return _table("mul", a.device)[((a << 8) | b).long()]


# ---------------------------------------------------------------------------
# Split / join for the Karatsuba recursion
# ---------------------------------------------------------------------------

def _split(level: int, a: torch.Tensor):
    """Element of T_level -> (lo, hi) in the T_{level-1} layout."""
    if level <= 5:
        h = 1 << (level - 1)
        return a & ((1 << h) - 1), shr(a, h)
    if level == 6:  # (..., 2) limbs of B32
        return a[..., 0], a[..., 1]
    return a[..., 0:2], a[..., 2:4]  # (..., 4) -> two B64


def _join(level: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    if level <= 5:
        return lo | (hi << (1 << (level - 1)))
    if level == 6:
        return torch.stack([lo, hi], dim=-1)
    return torch.cat([lo, hi], dim=-1)


# ---------------------------------------------------------------------------
# Multiplication, square, inversion
# ---------------------------------------------------------------------------

def mul_alpha(level: int, a: torch.Tensor) -> torch.Tensor:
    """Multiply by X_level (the level's adjoined variable)."""
    if level == 0:
        return a
    a0, a1 = _split(level, a)
    return _join(level, a1, a0 ^ mul_alpha(level - 1, a1))


def _mul_karatsuba(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba down to the B8 table: z0^z2 low, z1 ^ alpha*z2 high."""
    if level <= 3:
        return _mul_b8(a, b)
    a0, a1 = _split(level, a)
    b0, b1 = _split(level, b)
    z0 = _mul_karatsuba(level - 1, a0, b0)
    z2 = _mul_karatsuba(level - 1, a1, b1)
    z1 = _mul_karatsuba(level - 1, a0 ^ a1, b0 ^ b1) ^ z0 ^ z2
    return _join(level, z0 ^ z2, z1 ^ mul_alpha(level - 1, z2))


def mul(level: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise tower multiplication; batch shapes broadcast."""
    if level <= 4:
        return _mul_karatsuba(level, a, b)
    from . import bitslice_cuda
    return bitslice_cuda.mul(level, a, b)


def _scale_u32_lanes(sub_level: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x: lanes holding T_sub_level scalars; y: lanes whose byte / halfword
    fields are coordinates over T_sub_level. Broadcasts."""
    if sub_level == 5:
        return mul(5, x, y)
    if sub_level == 4:
        return mul(4, x, y & 0xFFFF) | (mul(4, x, shr(y, 16)) << 16)
    out = _mul_b8(x, y & 0xFF)
    for k in range(1, 4):
        out = out ^ (_mul_b8(x, shr(y, 8 * k) & 0xFF) << (8 * k))
    return out


def scale_subfield(sub_level: int, level: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y * embed(x) for T_sub_level scalars x: multiplication by a subfield
    scalar is coordinate-wise over that subfield, so it costs
    2^(level - sub_level) subfield products instead of the whole tree."""
    if sub_level >= level:
        return mul(level, x, y)
    if sub_level == 0:
        xb = x[..., None] if has_limb_dim(level) else x
        return torch.where(xb != 0, y, torch.zeros((), dtype=y.dtype, device=y.device))
    if level <= 5:
        return _scale_u32_lanes(sub_level, x, y)
    if sub_level <= 5:
        return _scale_u32_lanes(sub_level, x[..., None], y)
    # sub_level 6, level 7: two B64 coordinates
    return torch.cat([mul(6, x, y[..., 0:2]), mul(6, x, y[..., 2:4])], dim=-1)


def square(level: int, a: torch.Tensor) -> torch.Tensor:
    if level <= 3:
        return _table("square", a.device)[a.long()]
    a0, a1 = _split(level, a)
    s0 = square(level - 1, a0)
    s1 = square(level - 1, a1)
    return _join(level, s0 ^ s1, mul_alpha(level - 1, s1))


def is_zero(level: int, a: torch.Tensor) -> torch.Tensor:
    """Boolean mask of zero elements (batch shape)."""
    return (a == 0).all(dim=-1) if has_limb_dim(level) else a == 0


def select(level: int, mask: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """where(mask, x, y) with the mask over the batch shape."""
    if has_limb_dim(level):
        mask = mask[..., None]
    return torch.where(mask, x, y)


def invert(level: int, a: torch.Tensor) -> torch.Tensor:
    """Element-wise inversion with the convention invert(0) = 0."""
    if level <= 3:
        return _table("invert", a.device)[a.long()]
    a0, a1 = _split(level, a)
    hi_zero = is_zero(level - 1, a1)
    d = (square(level - 1, a0) ^ mul_alpha(level - 1, mul(level - 1, a0, a1))
         ^ square(level - 1, a1))
    dinv = invert(level - 1, select(level - 1, hi_zero, a0, d))
    b0 = mul(level - 1, a0 ^ mul_alpha(level - 1, a1), dinv)
    b1 = mul(level - 1, a1, dinv)
    return _join(level, select(level - 1, hi_zero, dinv, b0),
                 select(level - 1, hi_zero, torch.zeros_like(b1), b1))


def inner_product(level: int, a: torch.Tensor, b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Field dot product along a batch axis: sum_i a_i * b_i."""
    p = mul(level, a, b)
    if has_limb_dim(level) and axis < 0:
        axis -= 1
    return xor_reduce(p, axis)


# ---------------------------------------------------------------------------
# Embedding and subfield coordinates
# ---------------------------------------------------------------------------

def embed(sub_level: int, level: int, a: torch.Tensor) -> torch.Tensor:
    """Embed T_sub_level elements into T_level (the integer identity)."""
    if sub_level == level or level <= 5:
        return a
    k = n_limbs(level)
    if sub_level <= 5:
        return torch.cat([a[..., None], a.new_zeros((*a.shape, k - 1))], dim=-1)
    return torch.cat([a, a.new_zeros((*a.shape[:-1], k - n_limbs(sub_level)))], dim=-1)


def split_to_subfield(level: int, sub_level: int, a: torch.Tensor) -> torch.Tensor:
    """T_level elements -> 2^(level - sub_level) T_sub_level coefficients
    over the subfield basis: batch shape + (n_coeffs,) (+ limbs)."""
    if level == sub_level:
        return a[..., None] if not has_limb_dim(level) else a[..., None, :]
    n = 1 << (level - sub_level)
    sb = 1 << sub_level
    if level <= 5:
        shifts = torch.arange(n, dtype=torch.int32, device=a.device) * sb
        return (a[..., None] >> shifts) & ((1 << sb) - 1)
    if sb >= 32:
        out = a.reshape(*a.shape[:-1], n, sb // 32)
        return out[..., 0] if sub_level <= 5 else out
    per_limb = 32 // sb
    shifts = torch.arange(per_limb, dtype=torch.int32, device=a.device) * sb
    parts = (a[..., None] >> shifts) & ((1 << sb) - 1)
    return parts.reshape(*a.shape[:-1], n_limbs(level) * per_limb)


def join_from_subfield(level: int, sub_level: int, coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_to_subfield`."""
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
# GF(2)-linear maps through bit matrices
# ---------------------------------------------------------------------------

def to_bits(level: int, a: torch.Tensor) -> torch.Tensor:
    """T_level elements -> their 2^level bits as float64 0/1, LSB first:
    batch shape + (2^level,)."""
    words = a if has_limb_dim(level) else a[..., None]
    shifts = torch.arange(32, dtype=torch.int32, device=a.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :1 << level].to(torch.float64)


def from_bits(level: int, bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bits` for 0/1 values of any dtype."""
    nb = 1 << level
    b = bits.to(torch.int32)
    if nb < 32:
        b = torch.cat([b, b.new_zeros((*b.shape[:-1], 32 - nb))], dim=-1)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    words = xor_reduce(b.reshape(*b.shape[:-1], -1, 32) << shifts, -1)
    return words if has_limb_dim(level) else words[..., 0]


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
