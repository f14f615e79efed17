"""AES tower fields (AESTowerField8b..128b).

The port of `binius_tpu/fields/aes.py`, the counterpart of
`crates/field/src/aes_field.rs`: the Fan-Paar tower shape with Rijndael
GF(2^8) (0x11B) at level 3. Above level 3 the extension is chosen so that
the canonical <-> AES conversion is the B8 isomorphism applied to each byte
(the reference's AES_TO_BINARY_LINEAR_TRANSFORMATION, `aes_field.rs:107-
170`), so every AES-tower operation is the canonical one conjugated by the
per-byte map, which `isomorphism.py` derives from its anchor.

Multiplicative generators (`aes_field.rs:46-50`): 8b 0xD0, 16b 0x4745,
32b 0xBD478FAB, 64b 0x0DE1555D2BD78EB4,
128b 0x6DB54066349EDB96C33A87244A742678.
"""

from __future__ import annotations

import functools

import torch

from . import scalar, tower
from .isomorphism import aes_to_canonical_b8_matrix, canonical_to_aes_b8_matrix

GENERATORS = {
    3: 0xD0,
    4: 0x4745,
    5: 0xBD478FAB,
    6: 0x0DE1555D2BD78EB4,
    7: 0x6DB54066349EDB96C33A87244A742678,
}


def _map_bytes(cols: list[int], a: int, n_bytes: int) -> int:
    out = 0
    for i in range(n_bytes):
        out |= scalar.apply_linmap(cols, (a >> (8 * i)) & 0xFF) << (8 * i)
    return out


def aes_to_canonical(level: int, a: int) -> int:
    """The per-byte AES -> canonical map (levels 3..7)."""
    assert 3 <= level <= 7
    return _map_bytes(aes_to_canonical_b8_matrix(), a, 1 << (level - 3))


def canonical_to_aes(level: int, a: int) -> int:
    assert 3 <= level <= 7
    return _map_bytes(canonical_to_aes_b8_matrix(), a, 1 << (level - 3))


def mul(level: int, a: int, b: int) -> int:
    return canonical_to_aes(level, scalar.mul(
        level, aes_to_canonical(level, a), aes_to_canonical(level, b)))


def square(level: int, a: int) -> int:
    return canonical_to_aes(level, scalar.square(level, aes_to_canonical(level, a)))


def invert(level: int, a: int) -> int:
    return canonical_to_aes(level, scalar.invert(level, aes_to_canonical(level, a)))


def pow(level: int, a: int, e: int) -> int:  # noqa: A001
    return canonical_to_aes(level, scalar.pow(level, aes_to_canonical(level, a), e))


@functools.lru_cache(maxsize=None)
def _byte_map_u32_cols(to_canonical: bool) -> tuple:
    """The 32 columns of the B8 map applied to each byte of a 32-bit word."""
    cols8 = aes_to_canonical_b8_matrix() if to_canonical else canonical_to_aes_b8_matrix()
    return tuple(cols8[j % 8] << (8 * (j // 8)) for j in range(32))


def convert_device(level: int, data: torch.Tensor, to_canonical: bool) -> torch.Tensor:
    """The per-byte map applied to every byte of `data` (int32 words in the
    canonical layout of `level`, limbs included) on its device."""
    assert 3 <= level <= 7
    return tower.apply_bitmatrix(5, _byte_map_u32_cols(to_canonical), data)
