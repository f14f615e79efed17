"""Grøstl-256 from its specification, in plain Python and NumPy.

The 512-bit state is an 8 x 8 byte matrix filled column by column; a
column is held as a 64-bit int (byte i = row i). A round of P or Q adds
its constants, substitutes every byte by the AES S-box, rotates row i by
the permutation's shift and multiplies each column by the circulant
MixBytes matrix; the last three steps are one table lookup per byte
(`_T`). Compression is f(h, m) = P(h ^ m) ^ Q(m) ^ h, the digest
trunc_256(P(h) ^ h), and the Merkle 2-to-1 compression of two digests
a, b is trunc_256(P(a || b) ^ (a || b)).

`digest` and `Hasher` work on one message; `digest_rows` and
`compress_pairs` on NumPy batches, one lookup per byte for the batch.
"""

from __future__ import annotations

import numpy as np

ROUNDS = 10
SHIFT_P = (0, 1, 2, 3, 4, 5, 6, 7)
SHIFT_Q = (1, 3, 5, 7, 0, 2, 4, 6)
MIX = (2, 2, 3, 4, 5, 3, 5, 7)


def _gmul(a: int, b: int) -> int:
    """a * b in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a = (a << 1) ^ (0x11B if a & 0x80 else 0)
        b >>= 1
    return r


def _sbox() -> list[int]:
    inv = [0] * 256
    for x in range(1, 256):
        inv[x] = next(y for y in range(1, 256) if _gmul(x, y) == 1)
    out = []
    for x in range(256):
        b = inv[x]
        s = 0x63
        for k in range(5):   # b ^ rotl(b, 1) ^ ... ^ rotl(b, 4) ^ 0x63
            s ^= ((b << k) | (b >> (8 - k))) & 0xFF
        out.append(s)
    return out


SBOX = _sbox()
# _T[i][v]: the column that byte v in row i contributes after S-box and
# MixBytes: byte j = MIX[(i - j) % 8] * S(v)
_T = [[sum(_gmul(MIX[(i - j) % 8], SBOX[v]) << (8 * j) for j in range(8)) for v in range(256)]
      for i in range(8)]
# per round, per column: the constant XOR mask of P and of Q
_CP = [[((c << 4) ^ r) for c in range(8)] for r in range(ROUNDS)]
_CQ = [[0xFFFFFFFFFFFFFFFF ^ ((((c << 4) ^ r) & 0xFF) << 56) for c in range(8)]
       for r in range(ROUNDS)]


def _permute(cols: list[int], q: bool) -> list[int]:
    consts, shift = (_CQ, SHIFT_Q) if q else (_CP, SHIFT_P)
    T0, T1, T2, T3, T4, T5, T6, T7 = _T
    s0, s1, s2, s3, s4, s5, s6, s7 = shift
    for r in range(ROUNDS):
        x = [c ^ k for c, k in zip(cols, consts[r])]
        cols = [T0[x[(c + s0) & 7] & 0xFF] ^ T1[(x[(c + s1) & 7] >> 8) & 0xFF]
                ^ T2[(x[(c + s2) & 7] >> 16) & 0xFF] ^ T3[(x[(c + s3) & 7] >> 24) & 0xFF]
                ^ T4[(x[(c + s4) & 7] >> 32) & 0xFF] ^ T5[(x[(c + s5) & 7] >> 40) & 0xFF]
                ^ T6[(x[(c + s6) & 7] >> 48) & 0xFF] ^ T7[x[(c + s7) & 7] >> 56]
                for c in range(8)]
    return cols


def _cols(block: bytes) -> list[int]:
    return [int.from_bytes(block[8 * c:8 * c + 8], "little") for c in range(8)]


def _compress(h: list[int], m: list[int]) -> list[int]:
    p = _permute([a ^ b for a, b in zip(h, m)], False)
    q = _permute(m, True)
    return [a ^ b ^ c for a, b, c in zip(p, q, h)]


def _out(h: list[int]) -> bytes:
    p = _permute(h, False)
    return b"".join((a ^ b).to_bytes(8, "little") for a, b in zip(p, h))[32:]


IV = _cols(bytes(62) + b"\x01\x00")   # 256 as a 512-bit big-endian int


def padding(n: int) -> bytes:
    blocks = (n + 8) // 64 + 1
    return b"\x80" + bytes(blocks * 64 - n - 9) + blocks.to_bytes(8, "big")


class Hasher:
    """Incremental Grøstl-256: update, copy, finalize."""

    def __init__(self):
        self._h = list(IV)
        self._buf = b""
        self._n = 0

    def update(self, data: bytes) -> "Hasher":
        self._n += len(data)
        buf = self._buf + bytes(data)
        full = len(buf) - len(buf) % 64
        h = self._h
        for i in range(0, full, 64):
            h = _compress(h, _cols(buf[i:i + 64]))
        self._h, self._buf = h, buf[full:]
        return self

    def copy(self) -> "Hasher":
        c = Hasher.__new__(Hasher)
        c._h, c._buf, c._n = list(self._h), self._buf, self._n
        return c

    def finalize(self) -> bytes:
        tail = self._buf + padding(self._n)
        h = self._h
        for i in range(0, len(tail), 64):
            h = _compress(h, _cols(tail[i:i + 64]))
        return _out(h)


def digest(data: bytes) -> bytes:
    return Hasher().update(data).finalize()


# ---------------------------------------------------------------------------
# NumPy batches: states as (n, 8) uint64 columns
# ---------------------------------------------------------------------------

_TNP = np.array(_T, dtype=np.uint64)
_CPNP = np.array(_CP, dtype=np.uint64)
_CQNP = np.array(_CQ, dtype=np.uint64)


def _permute_np(x: np.ndarray, q: bool) -> np.ndarray:
    consts, shift = (_CQNP, SHIFT_Q) if q else (_CPNP, SHIFT_P)
    for r in range(ROUNDS):
        x = x ^ consts[r]
        byte = [((x >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.intp) for i in range(8)]
        out = np.empty_like(x)
        for c in range(8):
            acc = _TNP[0][byte[0][:, (c + shift[0]) & 7]]
            for i in range(1, 8):
                acc = acc ^ _TNP[i][byte[i][:, (c + shift[i]) & 7]]
            out[:, c] = acc
        x = out
    return x


def _rows_to_cols(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b, dtype=np.uint8).view("<u8").reshape(-1, 8).astype(np.uint64)


def _cols_to_rows(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<u8")).view(np.uint8).reshape(-1, 64)


def compress_pairs(pairs: np.ndarray) -> np.ndarray:
    """(n, 64) uint8 pairs of digests -> (n, 32) uint8."""
    m = _rows_to_cols(pairs.reshape(-1, 64))
    return _cols_to_rows(_permute_np(m, False) ^ m)[:, 32:]


def digest_rows(blobs: np.ndarray) -> np.ndarray:
    """Grøstl-256 of each row of an (n, L) uint8 array -> (n, 32) uint8."""
    n, length = blobs.shape
    pad = np.frombuffer(padding(length), dtype=np.uint8)
    msg = np.concatenate([blobs, np.broadcast_to(pad, (n, pad.size))], axis=1)
    h = np.tile(np.array(IV, dtype=np.uint64), (n, 1))
    for i in range(msg.shape[1] // 64):
        m = _rows_to_cols(msg[:, 64 * i:64 * i + 64])
        h = _permute_np(h ^ m, False) ^ _permute_np(m, True) ^ h
    return _cols_to_rows(_permute_np(h, False) ^ h)[:, 32:]


def merkle_root(leaf_digests: np.ndarray) -> bytes:
    cur = leaf_digests
    while cur.shape[0] > 1:
        cur = compress_pairs(cur.reshape(-1, 64))
    return cur[0].tobytes()
