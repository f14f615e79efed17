"""Grøstl-256 (the final SHA-3 submission), from the spec.

Counterpart of `binius_tpu/hash/groestl.py` without its native C dispatch:

  * the spec tables (AES S-box, GF(2^8)/0x11B products, round constants)
    derived from first principles;
  * a batched PyTorch permutation over (..., 8, 8) uint8 states
    (`_permute`, `compress`, `output_transform`, `compress_pairs_t`,
    `leaf_hash_t`), the plain version of K5 and K6, which runs on the host
    (CPU tensors) and on the card alike;
  * the T-table form on 64-bit column ints (`_ttables`, `_col_consts`,
    `_permute_cols`, `groestl256`, the incremental `Groestl256` of the
    transcript): host digests, and the tables that K5 and K6 read;
  * numpy entry points for the host top of a Merkle tree
    (`compress_pairs`, `hash_leaves_np`).

The 512-bit state is an 8x8 byte matrix filled column-wise; compression is
f(h, m) = P(h ^ m) ^ Q(m) ^ h and the output is trunc_256(P(h) ^ h).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

ROUNDS = 10
ROWS = 8
COLS = 8

# P shifts row i left by i; Q shifts by the spec's sigma_Q.
SHIFTS_P = (0, 1, 2, 3, 4, 5, 6, 7)
SHIFTS_Q = (1, 3, 5, 7, 0, 2, 4, 6)

# MixBytes circulant: B[i][j] = MIX[(j - i) % 8]
MIX = (2, 2, 3, 4, 5, 3, 5, 7)


def _gf_mul(a: int, b: int) -> int:
    """GF(2^8) multiply modulo the AES polynomial x^8+x^4+x^3+x+1 (0x11B)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


@functools.lru_cache(maxsize=None)
def aes_sbox() -> np.ndarray:
    """AES S-box from first principles (inverse, then the affine map)."""
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    table = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        b = inv[x]
        s = 0
        for i in range(8):
            bit = ((b >> i) ^ (b >> ((i + 4) % 8)) ^ (b >> ((i + 5) % 8))
                   ^ (b >> ((i + 6) % 8)) ^ (b >> ((i + 7) % 8)) ^ (0x63 >> i)) & 1
            s |= bit << i
        table[x] = s
    assert table[0] == 0x63 and table[1] == 0x7C and table[0x53] == 0xED
    return table


@functools.lru_cache(maxsize=None)
def gf_mul_table() -> np.ndarray:
    """mul_table[c][x] = c * x in GF(2^8)/0x11B for the MixBytes constants."""
    return np.array([[_gf_mul(c, x) for x in range(256)] for c in range(8)], dtype=np.uint8)


def bytes_to_state(data):
    """(..., 64) bytes -> (..., 8, 8) state[row, col], filled column-wise."""
    return data.reshape(*data.shape[:-1], COLS, ROWS).swapaxes(-1, -2)


def state_to_bytes(state):
    return state.swapaxes(-1, -2).reshape(*state.shape[:-2], 64)


@functools.lru_cache(maxsize=None)
def _consts() -> tuple[np.ndarray, np.ndarray]:
    """Round constants [ROUNDS, 8, 8] of P (row 0 ^= (c << 4) ^ r) and Q
    (every byte ^= 0xFF, row 7 ^= (c << 4) ^ r)."""
    col = np.arange(COLS, dtype=np.uint8) << 4
    p = np.zeros((ROUNDS, ROWS, COLS), dtype=np.uint8)
    q = np.full((ROUNDS, ROWS, COLS), 0xFF, dtype=np.uint8)
    for r in range(ROUNDS):
        p[r, 0] = col ^ np.uint8(r)
        q[r, ROWS - 1] ^= col ^ np.uint8(r)
    return p, q


# ---------------------------------------------------------------------------
# Batched permutation on torch uint8 states (plain version of K5/K6)
# ---------------------------------------------------------------------------

_DEV_TABLES: dict = {}


def _tables_on(device) -> tuple:
    key = str(device)
    if key not in _DEV_TABLES:
        pc, qc = _consts()
        _DEV_TABLES[key] = tuple(torch.from_numpy(a.copy()).to(device) for a in (
            aes_sbox(), gf_mul_table()[list(MIX)], pc, qc))
    return _DEV_TABLES[key]


def _permute(state: torch.Tensor, is_q: bool) -> torch.Tensor:
    """P or Q on (..., 8, 8) uint8 states."""
    sbox, mix_rows, pc, qc = _tables_on(state.device)
    consts = qc if is_q else pc
    shifts = SHIFTS_Q if is_q else SHIFTS_P
    for r in range(ROUNDS):
        state = sbox[(state ^ consts[r]).long()]
        # ShiftBytes: row i rotates left by shifts[i]
        state = torch.stack([torch.roll(state[..., i, :], -shifts[i], dims=-1)
                             for i in range(ROWS)], dim=-2)
        # MixBytes: out[i] = sum_off MIX[off] * state[(i + off) % 8]
        idx = state.long()
        acc = mix_rows[0][idx]
        for off in range(1, ROWS):
            acc = acc ^ torch.roll(mix_rows[off][idx], -off, dims=-2)
        state = acc
    return state


def compress(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """f(h, m) = P(h ^ m) ^ Q(m) ^ h on (..., 8, 8) states."""
    return _permute(h ^ m, False) ^ _permute(m, True) ^ h


def output_transform(h: torch.Tensor) -> torch.Tensor:
    """Omega(h) = trunc_256(P(h) ^ h) -> (..., 32) bytes."""
    return state_to_bytes(_permute(h, False) ^ h)[..., 32:]


IV_256 = np.zeros(64, dtype=np.uint8)
IV_256[62] = 0x01  # 512-bit big-endian encoding of 256


def groestl256_pad(n_bytes: int) -> np.ndarray:
    """Padding suffix for an n_bytes message: 0x80, zeros, 64-bit BE block count."""
    blocks = (n_bytes + 8) // 64 + 1
    pad = np.zeros(blocks * 64 - n_bytes, dtype=np.uint8)
    pad[0] = 0x80
    pad[-8:] = np.frombuffer(np.uint64(blocks).byteswap().tobytes(), dtype=np.uint8)
    return pad


def compress_pairs_t(pairs: torch.Tensor) -> torch.Tensor:
    """2-to-1 Merkle compression trunc_256(P(a||b) ^ (a||b)): (..., 64) uint8
    -> (..., 32) uint8."""
    m = bytes_to_state(pairs)
    return state_to_bytes(_permute(m, False) ^ m)[..., 32:]


def leaf_hash_t(blobs: torch.Tensor) -> torch.Tensor:
    """Grøstl-256 of each row: (N, L) uint8 -> (N, 32) uint8."""
    n, length = blobs.shape
    pad = torch.from_numpy(groestl256_pad(length)).to(blobs.device)
    msg = torch.cat([blobs, pad.expand(n, -1)], dim=1)
    h = bytes_to_state(torch.from_numpy(IV_256).to(blobs.device)).expand(n, 8, 8)
    for i in range(msg.shape[1] // 64):
        h = compress(h, bytes_to_state(msg[:, 64 * i:64 * (i + 1)]))
    return output_transform(h)


def compress_pairs(pairs: np.ndarray) -> np.ndarray:
    """Host 2-to-1 compression: (..., 64) uint8 numpy -> (..., 32) uint8."""
    return compress_pairs_t(torch.from_numpy(np.array(pairs, dtype=np.uint8))).numpy()


def hash_leaves_np(blobs: np.ndarray) -> np.ndarray:
    """Host digest of each row: (N, L) uint8 numpy -> (N, 32) uint8."""
    return leaf_hash_t(torch.from_numpy(np.array(blobs, dtype=np.uint8))).numpy()


# ---------------------------------------------------------------------------
# T-table form on 64-bit columns (byte i of a column = state row i)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ttables() -> tuple:
    """T[j][x] = 64-bit int whose byte i is MIX[(j-i)%8] * sbox[x]."""
    sbox = aes_sbox()
    out = []
    for j in range(ROWS):
        row = []
        for x in range(256):
            s = int(sbox[x])
            v = 0
            for i in range(ROWS):
                v |= _gf_mul(MIX[(j - i) % 8], s) << (8 * i)
            row.append(v)
        out.append(tuple(row))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _col_consts() -> tuple:
    """(p_consts, q_consts): per round, per column, a 64-bit XOR mask."""
    def pack(cs):
        return tuple(tuple(int(sum(int(cs[r][i, c]) << (8 * i) for i in range(ROWS)))
                           for c in range(COLS)) for r in range(ROUNDS))
    pc, qc = _consts()
    return pack(pc), pack(qc)


def kernel_tables_np() -> np.ndarray:
    """T-tables then P and Q column constants, as the uint64 array that K5
    and K6 copy into shared memory: [8*256 + 2*ROUNDS*8]."""
    pc, qc = _col_consts()
    return np.concatenate([np.array(_ttables(), dtype=np.uint64).reshape(-1),
                           np.array(pc, dtype=np.uint64).reshape(-1),
                           np.array(qc, dtype=np.uint64).reshape(-1)])


def _permute_cols(cols: list[int], is_q: bool) -> list[int]:
    """P or Q on a state given as 8 column ints."""
    T = _ttables()
    consts = _col_consts()[1 if is_q else 0]
    shifts = SHIFTS_Q if is_q else SHIFTS_P
    for r in range(ROUNDS):
        cols = [c ^ k for c, k in zip(cols, consts[r])]
        cols = [
            functools.reduce(lambda a, b: a ^ b, (
                T[i][(cols[(c + shifts[i]) % 8] >> (8 * i)) & 0xFF] for i in range(ROWS)))
            for c in range(COLS)]
    return cols


def _bytes_to_cols(data) -> list[int]:
    b = bytes(data)
    return [int.from_bytes(b[8 * c:8 * c + 8], "little") for c in range(COLS)]


def _cols_to_bytes(cols: list[int]) -> bytes:
    return b"".join(c.to_bytes(8, "little") for c in cols)


def _compress_cols(h: list[int], m: list[int]) -> list[int]:
    hp = _permute_cols([a ^ b for a, b in zip(h, m)], False)
    qm = _permute_cols(m, True)
    return [a ^ b ^ c for a, b, c in zip(hp, qm, h)]


def _digest_cols(h: list[int], tail: bytes) -> bytes:
    """Compress the padded tail's blocks into h, then the output transform."""
    for i in range(len(tail) // 64):
        h = _compress_cols(h, _bytes_to_cols(tail[64 * i:64 * (i + 1)]))
    x = _permute_cols(h, False)
    return _cols_to_bytes([a ^ b for a, b in zip(x, h)])[32:]


def groestl256(data: bytes) -> bytes:
    """One-shot Grøstl-256 digest (host, T-table path)."""
    msg = bytes(data) + groestl256_pad(len(data)).tobytes()
    return _digest_cols(_bytes_to_cols(IV_256.tobytes()), msg)


class Groestl256:
    """Incremental Grøstl-256 (update / copy / finalize), the hash of the
    Fiat-Shamir challenger."""

    def __init__(self):
        self._buf = bytearray()
        self._h = _bytes_to_cols(IV_256.tobytes())
        self._n_bytes = 0

    def update(self, data: bytes) -> "Groestl256":
        self._buf.extend(data)
        self._n_bytes += len(data)
        n_full = len(self._buf) // 64
        for i in range(n_full):
            self._h = _compress_cols(self._h, _bytes_to_cols(self._buf[64 * i:64 * (i + 1)]))
        del self._buf[:64 * n_full]
        return self

    def copy(self) -> "Groestl256":
        c = Groestl256.__new__(Groestl256)
        c._buf = bytearray(self._buf)
        c._h = list(self._h)
        c._n_bytes = self._n_bytes
        return c

    def finalize(self) -> bytes:
        tail = bytes(self._buf) + groestl256_pad(self._n_bytes).tobytes()
        return _digest_cols(list(self._h), tail)
