"""Scalar (Python-int) semantics of the Fan-Paar binary tower fields.

The port's own copy of the pure-Python tower arithmetic of
`binius_tpu/fields/scalar.py` (the native C dispatch is left out): the
ground truth that the host-side twiddle tables and the B8 device tables are
built from, and the verifier's arithmetic.

    T_0 = F2,   T_k = T_{k-1}[X_k] / (X_k^2 + X_{k-1}*X_k + 1)   with X_0 = 1.

An element of T_k is an integer < 2^(2^k); a = a0 + a1*X_k is encoded as
a0 | (a1 << 2^(k-1)). Levels 0..7 = B1, B2, B4, B8, B16, B32, B64, B128.
"""

from __future__ import annotations

import functools

import numpy as np

# a multiplicative generator of each level's field (B64's has order 2^64 - 1)
GENERATORS = {
    0: 0x1,
    1: 0x2,
    2: 0x5,
    3: 0x2D,
    4: 0xE2DE,
    5: 0x03E21CEA,
    6: 0x070F870DCD9C1D88,
    7: 0x2E895399AF449ACE499596F6E5FCCAFA,
}


def bits(level: int) -> int:
    return 1 << level


@functools.lru_cache(maxsize=None)
def _half_mask(level: int) -> int:
    return (1 << bits(level - 1)) - 1


def mul_alpha(level: int, a: int) -> int:
    """Multiply a in T_level by X_level: a * X_k = a1 + (a0 + a1*X_{k-1}) * X_k."""
    if level == 0:
        return a
    h = bits(level - 1)
    a0 = a & _half_mask(level)
    a1 = a >> h
    return a1 | ((a0 ^ mul_alpha(level - 1, a1)) << h)


def _mul_recursive(level: int, a: int, b: int) -> int:
    """Karatsuba multiplication down the tower (the definition)."""
    if level == 0:
        return a & b
    h = bits(level - 1)
    m = _half_mask(level)
    a0, a1 = a & m, a >> h
    b0, b1 = b & m, b >> h
    z0 = _mul_recursive(level - 1, a0, b0)
    z2 = _mul_recursive(level - 1, a1, b1)
    z1 = _mul_recursive(level - 1, a0 ^ a1, b0 ^ b1) ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ mul_alpha(level - 1, z2)) << h)


# -- fast host multiplication: flat B8 table + unrolled Karatsuba -----------

_MUL8: list | None = None
_ALPHA8: list | None = None


def _init_fast_tables() -> None:
    global _MUL8, _ALPHA8
    m8 = [0] * 65536
    for a in range(256):
        base = a << 8
        for b in range(256):
            m8[base | b] = _mul_recursive(3, a, b)
    _MUL8 = m8
    _ALPHA8 = [mul_alpha(3, v) for v in range(256)]


def _a16(v):
    lo = v >> 8
    return lo | (((v & 0xFF) ^ _ALPHA8[lo]) << 8)


def _a32(v):
    lo = v >> 16
    return lo | (((v & 0xFFFF) ^ _a16(lo)) << 16)


def _a64(v):
    lo = v >> 32
    return lo | (((v & 0xFFFFFFFF) ^ _a32(lo)) << 32)


def _m16(a, b, m8):
    a0, a1, b0, b1 = a & 0xFF, a >> 8, b & 0xFF, b >> 8
    z0 = m8[(a0 << 8) | b0]
    z2 = m8[(a1 << 8) | b1]
    z1 = m8[((a0 ^ a1) << 8) | (b0 ^ b1)] ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ _ALPHA8[z2]) << 8)


def _m32(a, b, m8):
    a0, a1, b0, b1 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    z0 = _m16(a0, b0, m8)
    z2 = _m16(a1, b1, m8)
    z1 = _m16(a0 ^ a1, b0 ^ b1, m8) ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ _a16(z2)) << 16)


def _m64(a, b, m8):
    a0, a1, b0, b1 = a & 0xFFFFFFFF, a >> 32, b & 0xFFFFFFFF, b >> 32
    z0 = _m32(a0, b0, m8)
    z2 = _m32(a1, b1, m8)
    z1 = _m32(a0 ^ a1, b0 ^ b1, m8) ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ _a32(z2)) << 32)


def _m128(a, b, m8):
    M = 0xFFFFFFFFFFFFFFFF
    a0, a1, b0, b1 = a & M, a >> 64, b & M, b >> 64
    z0 = _m64(a0, b0, m8)
    z2 = _m64(a1, b1, m8)
    z1 = _m64(a0 ^ a1, b0 ^ b1, m8) ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ _a64(z2)) << 64)


def mul_py(level: int, a: int, b: int) -> int:
    """Tower multiplication (defined by _mul_recursive)."""
    if _MUL8 is None:
        _init_fast_tables()
    if level <= 3:
        return _MUL8[(a << 8) | b]
    if level == 4:
        return _m16(a, b, _MUL8)
    if level == 5:
        return _m32(a, b, _MUL8)
    if level == 6:
        return _m64(a, b, _MUL8)
    return _m128(a, b, _MUL8)


def square_py(level: int, a: int) -> int:
    if level == 0:
        return a
    h = bits(level - 1)
    s0 = square_py(level - 1, a & _half_mask(level))
    s1 = square_py(level - 1, a >> h)
    return (s0 ^ s1) | (mul_alpha(level - 1, s1) << h)


def invert_py(level: int, a: int) -> int:
    """Tower inversion via the norm map. For a = a0 + a1*X_k, with
    d = a0^2 + a0*a1*X_{k-1} + a1^2: a^-1 = (a0 + a1*X_{k-1})/d + (a1/d)*X_k."""
    if a == 0:
        raise ZeroDivisionError("inversion of zero field element")
    if level == 0:
        return a
    h = bits(level - 1)
    a0 = a & _half_mask(level)
    a1 = a >> h
    if a1 == 0:
        return invert_py(level - 1, a0)
    d = (square_py(level - 1, a0) ^ mul_alpha(level - 1, mul_py(level - 1, a0, a1))
         ^ square_py(level - 1, a1))
    dinv = invert_py(level - 1, d)
    b0 = mul_py(level - 1, a0 ^ mul_alpha(level - 1, a1), dinv)
    b1 = mul_py(level - 1, a1, dinv)
    return b0 | (b1 << h)


def pow_py(level: int, a: int, e: int) -> int:
    r = 1
    base = a
    while e:
        if e & 1:
            r = mul_py(level, r, base)
        base = square_py(level, base)
        e >>= 1
    return r


mul, square, invert, pow = mul_py, square_py, invert_py, pow_py


def apply_linmap(cols: list[int], x: int) -> int:
    """The F2-linear map with column bitmasks `cols` applied to `x`."""
    out = 0
    j = 0
    while x:
        if x & 1:
            out ^= cols[j]
        x >>= 1
        j += 1
    return out


def invert_matrix(cols: list[int], n: int) -> list[int]:
    """Invert an n x n F2 matrix given as column bitmasks (Gauss-Jordan)."""
    rows = []   # rows of [A | I]: row i has bit j = A[i][j]
    for i in range(n):
        r = 0
        for j in range(n):
            if (cols[j] >> i) & 1:
                r |= 1 << j
        rows.append((r, 1 << i))
    for col in range(n):
        piv = next((k for k in range(col, n) if (rows[k][0] >> col) & 1), None)
        if piv is None:
            raise ValueError("singular matrix")
        rows[col], rows[piv] = rows[piv], rows[col]
        for k in range(n):
            if k != col and (rows[k][0] >> col) & 1:
                rows[k] = (rows[k][0] ^ rows[col][0], rows[k][1] ^ rows[col][1])
    inv_cols = []   # rows[i][1] is row i of A^-1
    for j in range(n):
        c = 0
        for i in range(n):
            if (rows[i][1] >> j) & 1:
                c |= 1 << i
        inv_cols.append(c)
    return inv_cols


# -- B8 tables for the device base case (levels <= 3) -----------------------

@functools.lru_cache(maxsize=None)
def b8_mul_table() -> np.ndarray:
    """Flat 65536-entry uint8 table: [(a << 8) | b] = a * b in T_3. Covers
    every level <= 3: subfields embed as the identity and are closed."""
    if _MUL8 is None:
        _init_fast_tables()
    return np.array(_MUL8, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def b8_square_table() -> np.ndarray:
    return np.array([square_py(3, a) for a in range(256)], dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def b8_invert_table() -> np.ndarray:
    """invert(0) is 0 in the table; the device ops use that convention."""
    return np.array([0] + [invert_py(3, a) for a in range(1, 256)], dtype=np.uint8)
