"""The binary tower fields B1 ... B128 of Binius, in plain Python and NumPy.

    T_0 = F2,   T_k = T_{k-1}[X_k] / (X_k^2 + X_{k-1} X_k + 1),   X_0 = 1.

An element of T_k is an int below 2^(2^k); a0 + a1 X_k is a0 | (a1 << 2^(k-1)).
A subfield element is the same int in every larger field, so one product
serves every level. Products go down the tower by Karatsuba to a 256 x 256
table of B8 products, which the definition itself fills, and B16 products go
through the logarithm tables of B16.

`ScalarMul` is multiplication by one fixed B128 element as an F2-linear map:
16 byte tables, applied to NumPy arrays of (lo, hi) uint64 pairs.
"""

from __future__ import annotations

import numpy as np

M64 = (1 << 64) - 1


def _mul_alpha_def(level: int, a):
    """a * X_level by the definition (ints or NumPy arrays)."""
    if level == 0:
        return a
    h = 1 << (level - 1)
    a0, a1 = a & ((1 << h) - 1), a >> h
    return a1 | ((a0 ^ _mul_alpha_def(level - 1, a1)) << h)


def _mul_def(level: int, a, b):
    """The product in T_level by the definition (ints or NumPy arrays)."""
    if level == 0:
        return a & b
    h = 1 << (level - 1)
    m = (1 << h) - 1
    a0, a1, b0, b1 = a & m, a >> h, b & m, b >> h
    z0 = _mul_def(level - 1, a0, b0)
    z2 = _mul_def(level - 1, a1, b1)
    z1 = _mul_def(level - 1, a0 ^ a1, b0 ^ b1) ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ _mul_alpha_def(level - 1, z2)) << h)


_v = np.arange(256, dtype=np.int64)
MUL8 = _mul_def(3, _v[:, None], _v[None, :]).reshape(-1).tolist()
ALPHA8 = _mul_alpha_def(3, _v).tolist()
del _v


# B16 by logarithms: a generator of its multiplicative group (order 65535)
# and the tables of its powers and logarithms; then Karatsuba on 16-bit
# limbs for B32, B64 and B128 (27 B16 products per B128 product)
GEN16 = 0xE2DE


def _mul16_def(a: int, b: int) -> int:
    a0, a1, b0, b1 = a & 0xFF, a >> 8, b & 0xFF, b >> 8
    z0 = MUL8[(a0 << 8) | b0]
    z2 = MUL8[(a1 << 8) | b1]
    z1 = MUL8[((a0 ^ a1) << 8) | (b0 ^ b1)] ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ ALPHA8[z2]) << 8)


def _log_tables() -> tuple[list, list]:
    exp = [1] * (2 * 65535)
    x = 1
    for i in range(1, 65535):
        x = _mul16_def(x, GEN16)
        exp[i] = x
    assert x != 1 and _mul16_def(x, GEN16) == 1, "GEN16 must generate B16*"
    exp[65535:] = exp[:65535]
    log = [0] * 65536
    for i in range(65535):
        log[exp[i]] = i
    return exp, log


EXP16, LOG16 = _log_tables()
# v * X_4 for every B16 element v (X_4 is 0x100)
ALPHA16 = [0] + [EXP16[LOG16[v] + LOG16[0x100]] for v in range(1, 65536)]


def _mul32(a, b):
    E, L = EXP16, LOG16
    a0, a1, b0, b1 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    z0 = E[L[a0] + L[b0]] if a0 and b0 else 0
    z2 = E[L[a1] + L[b1]] if a1 and b1 else 0
    c, d = a0 ^ a1, b0 ^ b1
    z1 = (E[L[c] + L[d]] if c and d else 0) ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ ALPHA16[z2]) << 16)


def _alpha32(v):
    lo = v >> 16
    return lo | (((v & 0xFFFF) ^ ALPHA16[lo]) << 16)


def _alpha64(v):
    lo = v >> 32
    return lo | (((v & 0xFFFFFFFF) ^ _alpha32(lo)) << 32)


def _mul64(a, b):
    if a <= 0xFFFFFFFF and b <= 0xFFFFFFFF:
        return _mul32(a, b)
    a0, a1, b0, b1 = a & 0xFFFFFFFF, a >> 32, b & 0xFFFFFFFF, b >> 32
    z0 = _mul32(a0, b0)
    z2 = _mul32(a1, b1)
    z1 = _mul32(a0 ^ a1, b0 ^ b1) ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ _alpha32(z2)) << 32)


def mul(a: int, b: int) -> int:
    """The product of two tower elements (any levels, up to B128)."""
    if a <= 1:
        return b if a else 0
    if b <= 1:
        return a if b else 0
    if a <= M64 and b <= M64:
        return _mul64(a, b)
    a0, a1, b0, b1 = a & M64, a >> 64, b & M64, b >> 64
    z0 = _mul64(a0, b0)
    z2 = _mul64(a1, b1)
    z1 = _mul64(a0 ^ a1, b0 ^ b1) ^ z0 ^ z2
    return (z0 ^ z2) | ((z1 ^ _alpha64(z2)) << 64)


def power(a: int, e: int) -> int:
    out = 1
    while e:
        if e & 1:
            out = mul(out, a)
        a = mul(a, a)
        e >>= 1
    return out


def invert(a: int, level: int = 7) -> int:
    """a^-1 in T_level, as a^(|T_level| - 2)."""
    if a == 0:
        raise ZeroDivisionError("zero has no inverse")
    return power(a, (1 << (1 << level)) - 2)


def eq_expand(point: list[int]) -> list[int]:
    """eq(point, v) for every v, v's bit i the i-th coordinate's side."""
    out = [1]
    for r in point:
        out = [mul(c, r ^ 1) for c in out] + [mul(c, r) for c in out]
    return out


def eq_at(x: list[int], y: list[int]) -> int:
    acc = 1
    for a, b in zip(x, y):
        acc = mul(acc, mul(a, b) ^ mul(a ^ 1, b ^ 1))
    return acc


def mle_fold(values: list[int], point: list[int]) -> int:
    """The multilinear extension of `values` at `point` (coordinate 0 the
    lowest index bit)."""
    cur = list(values)
    for r in point:
        cur = [cur[2 * i] ^ mul(cur[2 * i] ^ cur[2 * i + 1], r) for i in range(len(cur) // 2)]
    return cur[0]


# ---------------------------------------------------------------------------
# NumPy: B128 elements as (n, 2) uint64 (lo, hi)
# ---------------------------------------------------------------------------

def to_pairs(values) -> np.ndarray:
    return np.array([(v & M64, v >> 64) for v in values], dtype=np.uint64).reshape(-1, 2)


def from_pair(p) -> int:
    return int(p[0]) | (int(p[1]) << 64)


class ScalarMul:
    """x -> s * x for one B128 element s, as 16 byte tables of (lo, hi)."""

    def __init__(self, s: int):
        images = to_pairs([mul(s, 1 << b) for b in range(128)]).reshape(16, 8, 2)
        t = np.zeros((16, 256, 2), dtype=np.uint64)
        for b in range(8):   # the entries with bit b set: those below it, plus its image
            t[:, 1 << b:2 << b] = t[:, :1 << b] ^ images[:, b][:, None]
        self.tables = t

    def __call__(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros_like(x)
        for k in range(16):
            byte = (x[:, k // 8] >> np.uint64(8 * (k % 8))) & np.uint64(0xFF)
            out ^= self.tables[k][byte.astype(np.intp)]
        return out
