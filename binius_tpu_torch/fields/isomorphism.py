"""The AES <-> canonical tower isomorphism at B8.

The port of the two B8 basis changes of `binius_tpu/fields/isomorphism.py`
that the Grøstl gadget's constants read. The isomorphism is anchored, as
the reference anchors it, on the image 0x3C of the Rijndael generator x
(0x02): any root of x^8 + x^4 + x^3 + x + 1 in the tower gives an
isomorphism, and this one makes the derived constants equal the
reference's. (POLYVAL and the 128-bit basis changes are not ported.)
"""

from __future__ import annotations

import functools

from . import scalar

_AES_GENERATOR_IMAGE = 0x3C


@functools.lru_cache(maxsize=None)
def aes_to_canonical_b8_matrix() -> list[int]:
    """8x8 F2 map AES GF(2^8) -> canonical B8: column j is the image of x^j,
    the tower power basis of the anchored Rijndael root."""
    g = _AES_GENERATOR_IMAGE
    pw = [1]
    for _ in range(8):
        pw.append(scalar.mul(3, pw[-1], g))
    assert pw[8] ^ pw[4] ^ pw[3] ^ pw[1] ^ pw[0] == 0, \
        "anchored AES generator image is not a Rijndael root"
    return pw[:8]


@functools.lru_cache(maxsize=None)
def canonical_to_aes_b8_matrix() -> list[int]:
    return scalar.invert_matrix(aes_to_canonical_b8_matrix(), 8)
