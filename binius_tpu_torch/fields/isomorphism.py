"""Field isomorphisms: canonical tower <-> AES tower <-> POLYVAL.

The port's copy of `binius_tpu/fields/isomorphism.py` (host Python ints),
the counterpart of the reference's AES tower (`crates/field/src/
aes_field.rs`), POLYVAL field (`crates/field/src/polyval.rs`) and basis
changes (`crates/field/src/linear_transformation.rs`).

The isomorphisms are derived, not copied as tables: a Fan-Paar tower embeds
into any binary field of matching degree by solving its defining quadratics
X_{k+1}^2 + X_k X_{k+1} + 1 = 0 level by level (a quadratic over F2 is
linear algebra: z = b*s with s^2 + s = c/b^2, solved through the F2-linear
map s -> s^2 + s). The embedding of the canonical basis gives the 128x128
F2 change-of-basis matrices.
"""

from __future__ import annotations

import functools

from . import scalar

# -- POLYVAL: GF(2)[x] / (x^128 + x^127 + x^126 + x^121 + 1) ---------------

POLYVAL_MODULUS = (1 << 128) | (1 << 127) | (1 << 126) | (1 << 121) | 1


def polyval_mul(a: int, b: int) -> int:
    """Carry-less product, reduced modulo the POLYVAL polynomial."""
    r = 0
    while b:
        lsb = b & -b
        r ^= a << lsb.bit_length() - 1
        b ^= lsb
    for bit in range(254, 127, -1):
        if (r >> bit) & 1:
            r ^= POLYVAL_MODULUS << (bit - 128)
    return r & ((1 << 128) - 1)


def polyval_pow(a: int, e: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = polyval_mul(r, a)
        a = polyval_mul(a, a)
        e >>= 1
    return r


def polyval_inv(a: int) -> int:
    return polyval_pow(a, (1 << 128) - 2)


def aes_b8_mul(a: int, b: int) -> int:
    """Product in Rijndael GF(2^8), x^8 + x^4 + x^3 + x + 1."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


# -- the embedding: the tower's quadratics solved in a target field --------

def _solve_artin_schreier(mul, square, n_bits: int, d: int):
    """s with s^2 + s = d over GF(2^n_bits) given by its bit-vector ops, or
    None: L(s) = s^2 + s is F2-linear, so Gaussian elimination solves it."""
    cols = [square(1 << j) ^ (1 << j) for j in range(n_bits)]
    rows = []
    for i in range(n_bits):
        r = 0
        for j in range(n_bits):
            if (cols[j] >> i) & 1:
                r |= 1 << j
        rows.append((r, (d >> i) & 1))
    pivots = []
    for col in range(n_bits):
        piv = next((k for k in range(len(pivots), n_bits) if (rows[k][0] >> col) & 1), None)
        if piv is None:
            continue
        k0 = len(pivots)
        rows[k0], rows[piv] = rows[piv], rows[k0]
        for k in range(n_bits):
            if k != k0 and (rows[k][0] >> col) & 1:
                rows[k] = (rows[k][0] ^ rows[k0][0], rows[k][1] ^ rows[k0][1])
        pivots.append((col, k0))
    sol = 0
    for col, k in pivots:
        if rows[k][1]:
            sol |= 1 << col
    # half of all d have no solution: the system is then inconsistent
    return sol if square(sol) ^ sol == d else None


def derive_tower_embedding(mul, n_bits: int = 128, levels: int = 7) -> list[int]:
    """Images of the tower generators X_1..X_levels in the target field,
    solving X_{k+1}^2 + X_k X_{k+1} + 1 = 0 level by level (X_0 = 1); of the
    two roots z and z + X_k, the smaller integer."""
    def square(a):
        return mul(a, a)

    def inv(a):
        r, e = 1, (1 << n_bits) - 2
        while e:
            if e & 1:
                r = mul(r, a)
            a = mul(a, a)
            e >>= 1
        return r

    images = []
    xk = 1
    for _ in range(levels):
        # z^2 + xk z + 1 = 0: z = xk s with s^2 + s = 1 / xk^2
        xk_inv = inv(xk)
        s = _solve_artin_schreier(mul, square, n_bits, mul(xk_inv, xk_inv))
        assert s is not None, "tower quadratic has no root (field mismatch)"
        z = mul(xk, s)
        z = min(z, z ^ xk)
        images.append(z)
        xk = z
    return images


@functools.lru_cache(maxsize=None)
def canonical_basis_images(mul_name: str) -> list[int]:
    """Images of the 128 canonical F2 basis elements in the target field:
    2^i = prod_j X_{j+1}^{bit j of i} in the canonical tower."""
    mul = {"polyval": polyval_mul}[mul_name]
    gens = derive_tower_embedding(mul)
    images = []
    for i in range(128):
        acc = 1
        for j in range(7):
            if (i >> j) & 1:
                acc = mul(acc, gens[j])
        images.append(acc)
    return images


def _check_canonical_decomposition() -> bool:
    """In the canonical tower, 2^i = prod_j X_{j+1}^{i_j}."""
    for i in range(0, 128, 17):
        acc = 1
        for j in range(7):
            if (i >> j) & 1:
                acc = scalar.mul(7, acc, 1 << (1 << j))
        assert acc == 1 << i, (i, acc)
    return True


@functools.lru_cache(maxsize=None)
def canonical_to_polyval_matrix() -> list[int]:
    """Column bitmasks: column i is the POLYVAL image of canonical 2^i."""
    _check_canonical_decomposition()
    return list(canonical_basis_images("polyval"))


@functools.lru_cache(maxsize=None)
def polyval_to_canonical_matrix() -> list[int]:
    return scalar.invert_matrix(canonical_to_polyval_matrix(), 128)


def canonical_to_polyval(a: int) -> int:
    return scalar.apply_linmap(canonical_to_polyval_matrix(), a)


def polyval_to_canonical(a: int) -> int:
    return scalar.apply_linmap(polyval_to_canonical_matrix(), a)


# -- the AES tower (Rijndael GF(2^8) at level 3) ----------------------------

# The isomorphism is anchored, as the reference anchors it
# (`aes_field.rs:116`), on the image 0x3C of the Rijndael generator x (0x02):
# any root of x^8 + x^4 + x^3 + x + 1 in the tower gives an isomorphism, and
# this one makes the derived constants equal the reference's.
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
