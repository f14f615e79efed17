"""Scalar (Python-int) semantics of the Fan-Paar binary tower fields.

The port's copy of `binius_tpu/fields/scalar.py`: the ground truth that the
host-side twiddle tables and the B8 device tables are built from, and the
host's arithmetic (transcript math, the verifiers). `mul`, `invert` and
`pow` run in the native C library (`native/b128.c`) from the operand size
where it is faster than Python, and in the pure-Python plain versions
`mul_py`, `invert_py`, `pow_py` below it; `square` is `square_py`.

    T_0 = F2,   T_k = T_{k-1}[X_k] / (X_k^2 + X_{k-1}*X_k + 1)   with X_0 = 1.

An element of T_k is an integer < 2^(2^k); a = a0 + a1*X_k is encoded as
a0 | (a1 << 2^(k-1)). Levels 0..7 = B1, B2, B4, B8, B16, B32, B64, B128.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .. import native

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


def add(a: int, b: int) -> int:
    """Field addition: XOR (characteristic 2)."""
    return a ^ b


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
    # the definition run once on all 65536 pairs: its bit operations work
    # element-wise on numpy arrays
    v = np.arange(256, dtype=np.int64)
    _MUL8 = _mul_recursive(3, v[:, None], v[None, :]).reshape(-1).tolist()
    _ALPHA8 = mul_alpha(3, v).tolist()


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
    """Tower multiplication (defined by _mul_recursive), of elements of
    T_level. It runs at the smallest level whose subfield holds both: the
    subfields embed as the integer identity and are closed under
    multiplication."""
    if _MUL8 is None:
        _init_fast_tables()
    m = a | b
    if m < 0x100:
        return _MUL8[(a << 8) | b]
    if m < 0x10000:
        return _m16(a, b, _MUL8)
    if m < 0x100000000:
        return _m32(a, b, _MUL8)
    if m < 0x10000000000000000:
        return _m64(a, b, _MUL8)
    return _m128(a, b, _MUL8)


# _SQUARE[k][v] = (v << 8k)^2: squaring is F2-linear and a subfield's
# elements square to the same integers in every larger level, so a square
# is the XOR of one entry per byte
_SQUARE: list | None = None


def _init_square_tables() -> None:
    global _SQUARE
    tables = []
    for k in range(16):
        t = [0]
        for j in range(8):
            sq = mul_py(7, 1 << (8 * k + j), 1 << (8 * k + j))
            t += [v ^ sq for v in t]
        tables.append(t)
    _SQUARE = tables


def square_py(level: int, a: int) -> int:
    """a * a in T_level, one table entry per byte."""
    if _SQUARE is None:
        _init_square_tables()
    del level
    out = 0
    k = 0
    while a:
        out ^= _SQUARE[k][a & 0xFF]
        a >>= 8
        k += 1
    return out


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


# -- native C dispatch (`native/b128.c`) -------------------------------------
# The C takes an operand at the smallest level that holds it, as `mul_py`
# computes (the subfields embed as the integer identity). A ctypes call costs
# about 1-2 us, so a product of operands below PY_MUL_BELOW (B16) and the
# inverse of an element below PY_INVERT_BELOW (B2) stay in Python, and so
# does every square (a table entry per byte): there Python was as fast or
# faster on the card's host (`chip_smoke.py`'s native phase times both).
PY_MUL_BELOW = 1 << 16
PY_INVERT_BELOW = 1 << 2

_M64 = (1 << 64) - 1
# the result of every scalar entry: one buffer, as the port's host algebra
# runs on one thread per process
_OUT = (ctypes.c_uint64 * 2)()


def _bind_native() -> None:
    """Bind the C entries once: the first call of each builds the library."""
    global _tower_mul, _tower_invert, _tower_pow
    lib = native.get_lib()
    _tower_mul, _tower_invert, _tower_pow = lib.tower_mul, lib.tower_invert, lib.tower_pow


def _first_call(name: str):
    def call(*args):
        _bind_native()
        return globals()[name](*args)
    return call


_tower_mul = _first_call("_tower_mul")
_tower_invert = _first_call("_tower_invert")
_tower_pow = _first_call("_tower_pow")


def _level_of(m: int) -> int:
    """The smallest level >= 3 that holds m."""
    if m < 0x100:
        return 3
    if m < 0x10000:
        return 4
    if m < 0x100000000:
        return 5
    return 6 if m <= _M64 else 7


def mul(level: int, a: int, b: int) -> int:
    """a * b (`mul_py`'s product), in C from `PY_MUL_BELOW` on."""
    m = a | b
    if m < PY_MUL_BELOW:
        return mul_py(level, a, b)
    _tower_mul(_level_of(m), a & _M64, a >> 64, b & _M64, b >> 64, _OUT)
    return _OUT[0] | (_OUT[1] << 64)


square = square_py


def invert(level: int, a: int) -> int:
    """a^-1 (`invert_py`'s), in C from `PY_INVERT_BELOW` on."""
    if a < PY_INVERT_BELOW or a == 0:
        return invert_py(level, a)
    _tower_invert(_level_of(a), a & _M64, a >> 64, _OUT)
    return _OUT[0] | (_OUT[1] << 64)


def pow(level: int, a: int, e: int) -> int:  # noqa: A001
    """a^e (`pow_py`'s), in C for exponents below 2^64."""
    if e >> 64 or e < 0:
        return pow_py(level, a, e)
    _tower_pow(_level_of(a), a & _M64, a >> 64, e, _OUT)
    return _OUT[0] | (_OUT[1] << 64)


def mul_pairs(level: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Element-wise products of (k, 2) uint64 pairs (low word, high word)
    in C (`tower_mul_batch`); below level 7 every element must lie in the
    level's field (its high word 0)."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    if a.shape != b.shape or a.shape[1:] != (2,):
        raise ValueError(f"mul_pairs: shapes {a.shape} and {b.shape}")
    if level < 7 and a.size and max(int(a.max()), int(b.max())) >> bits(level):
        raise ValueError(f"mul_pairs: an element does not lie in level {level}")
    out = np.empty_like(a)
    native.get_lib().tower_mul_batch(level, a.ctypes.data, b.ctypes.data, out.ctypes.data,
                                     a.shape[0])
    return out


def mul_pairs_py(level: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`mul_pairs`' plain version."""
    prods = [mul_py(level, a0 | (a1 << 64), b0 | (b1 << 64))
             for (a0, a1), (b0, b1) in zip(np.asarray(a).tolist(), np.asarray(b).tolist())]
    return np.array([(v & _M64, v >> 64) for v in prods], dtype=np.uint64).reshape(-1, 2)


def multiplicative_order(level: int, a: int) -> int:
    """Order of `a` in T_level^* by search (levels <= 4 only)."""
    assert level <= 4, "order search only for small fields"
    x = a
    for i in range(1, 1 << bits(level)):
        if x == 1:
            return i
        x = mul(level, x, a)
    raise ValueError("not a unit")


# -- F2 linear algebra: a matrix is a list of column bitmasks (column j is
# the image of basis vector e_j) -------------------------------------------

def linmap_columns(level: int, f) -> list[int]:
    """Columns of the F2-matrix of a linear map f over T_level's F2-basis."""
    return [f(1 << j) for j in range(bits(level))]


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


def mul_matrix(level: int, c: int) -> list[int]:
    """Columns of multiplication by the constant c, an F2-linear map on T_level."""
    return [mul(level, c, 1 << j) for j in range(bits(level))]


def square_matrix(level: int) -> list[int]:
    return linmap_columns(level, lambda x: square(level, x))


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


def matrix_to_numpy_bits(cols: list[int], n_out_bits: int) -> np.ndarray:
    """Column bitmasks -> uint8 bit matrix M[out_bit, in_bit]."""
    c = np.array([[(col >> i) & 1 for i in range(n_out_bits)] for col in cols],
                 dtype=np.uint8).reshape(len(cols), n_out_bits)
    return np.ascontiguousarray(c.T)


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


@functools.lru_cache(maxsize=None)
def b16_tables() -> dict:
    """T_4 (B16) as 65536-entry int64 tables: log and exp to the base of
    its generator (exp[i] = g^(i mod 65535) for i < 2 * 65535, so a sum of
    two logs needs no reduction; log[0] is unused), the inverse (with
    invert(0) = 0), the square and the product by X_4."""
    g = GENERATORS[4]
    powers = [1]
    for _ in range(65534):
        powers.append(mul_py(4, powers[-1], g))
    exp = np.array(powers + powers, dtype=np.int64)
    log = np.zeros(1 << 16, dtype=np.int64)
    log[exp[:65535]] = np.arange(65535)
    inv = np.zeros(1 << 16, dtype=np.int64)
    inv[exp[:65535]] = exp[(-np.arange(65535)) % 65535]
    v = np.arange(256)
    # squaring and the product by X_4 are F2-linear: one table per byte
    sq = [np.array([square_py(4, int(x) << (8 * k)) for x in v]) for k in (0, 1)]
    ma = [np.array([mul_alpha(4, int(x) << (8 * k)) for x in v]) for k in (0, 1)]
    w = np.arange(1 << 16)
    return {"log": log, "exp": exp, "invert": inv,
            "square": (sq[0][w & 0xFF] ^ sq[1][w >> 8]).astype(np.int64),
            "mul_alpha": (ma[0][w & 0xFF] ^ ma[1][w >> 8]).astype(np.int64)}


@functools.lru_cache(maxsize=None)
def b8_mul_alpha_table() -> np.ndarray:
    """Multiplication by X_3 (0x10) in T_3, per byte."""
    return np.array([mul_alpha(3, a) for a in range(256)], dtype=np.uint8)
