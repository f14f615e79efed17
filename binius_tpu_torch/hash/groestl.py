"""Grøstl-256 (the final SHA-3 submission), from the spec.

Counterpart of `binius_tpu/hash/groestl.py`:

  * the spec tables (AES S-box, GF(2^8)/0x11B products, round constants)
    derived from first principles;
  * a batched PyTorch permutation over (..., 8, 8) uint8 states
    (`_permute`, `compress`, `output_transform`, `compress_pairs_t`,
    `leaf_hash_t`), the plain version of K5 and K6, which runs on the host
    (CPU tensors) and on the card alike;
  * the T-table form on 64-bit column ints (`_ttables`, `_col_consts`):
    the tables that K5, K6 and the native C core (`native/groestl.c`)
    read, and the pure-Python plain versions `_py_permute_cols`,
    `_py_compress_cols`, `_py_groestl256`;
  * the host entries, each in C: `_permute_cols`, `_compress_cols`,
    `groestl256`, the incremental `Groestl256` of the transcript
    (`compress_seq_native`), and the numpy batches of host Merkle hashing
    (`compress_pairs`, `hash_leaves_np` through `digest_rows_native`).

The 512-bit state is an 8x8 byte matrix filled column-wise; compression is
f(h, m) = P(h ^ m) ^ Q(m) ^ h and the output is trunc_256(P(h) ^ h).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import native

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


@functools.lru_cache(maxsize=None)
def _col_sources(is_q: bool) -> tuple:
    """Per output column c, the input column that row i's byte comes from."""
    shifts = SHIFTS_Q if is_q else SHIFTS_P
    return tuple(tuple((c + shifts[i]) % 8 for i in range(ROWS)) for c in range(COLS))


def _py_permute_cols(cols: list[int], is_q: bool) -> list[int]:
    """P or Q on a state given as 8 column ints (plain version)."""
    T0, T1, T2, T3, T4, T5, T6, T7 = _ttables()
    consts = _col_consts()[1 if is_q else 0]
    src = _col_sources(is_q)
    for r in range(ROUNDS):
        x = [c ^ k for c, k in zip(cols, consts[r])]
        cols = [T0[x[a] & 0xFF] ^ T1[(x[b] >> 8) & 0xFF] ^ T2[(x[c] >> 16) & 0xFF]
                ^ T3[(x[d] >> 24) & 0xFF] ^ T4[(x[e] >> 32) & 0xFF] ^ T5[(x[f] >> 40) & 0xFF]
                ^ T6[(x[g] >> 48) & 0xFF] ^ T7[x[h] >> 56]
                for a, b, c, d, e, f, g, h in src]
    return cols


def _bytes_to_cols(data) -> list[int]:
    b = bytes(data)
    return [int.from_bytes(b[8 * c:8 * c + 8], "little") for c in range(COLS)]


def _cols_to_bytes(cols: list[int]) -> bytes:
    return b"".join(c.to_bytes(8, "little") for c in cols)


def _py_compress_cols(h: list[int], m: list[int]) -> list[int]:
    hp = _py_permute_cols([a ^ b for a, b in zip(h, m)], False)
    qm = _py_permute_cols(m, True)
    return [a ^ b ^ c for a, b, c in zip(hp, qm, h)]


def _py_groestl256(data: bytes) -> bytes:
    """One-shot Grøstl-256 digest (plain version, T-table path)."""
    msg = bytes(data) + groestl256_pad(len(data)).tobytes()
    h = _bytes_to_cols(IV_256.tobytes())
    for i in range(len(msg) // 64):
        h = _py_compress_cols(h, _bytes_to_cols(msg[64 * i:64 * (i + 1)]))
    x = _py_permute_cols(h, False)
    return _cols_to_bytes([a ^ b for a, b in zip(x, h)])[32:]


# ---------------------------------------------------------------------------
# The host entries in C (`native/groestl.c`), initialised with the tables
# above: no constant lives in C
# ---------------------------------------------------------------------------

_Cols = ctypes.c_uint64 * COLS
_IV_COLS = _Cols(*_bytes_to_cols(IV_256.tobytes()))


@functools.lru_cache(maxsize=None)
def _native_lib() -> ctypes.CDLL:
    lib = native.get_lib()
    t = np.array(_ttables(), dtype=np.uint64)
    pc, qc = (np.array(c, dtype=np.uint64) for c in _col_consts())
    sp, sq = (np.array(s, dtype=np.int32) for s in (SHIFTS_P, SHIFTS_Q))
    lib.groestl_init(t.ctypes.data, pc.ctypes.data, qc.ctypes.data, sp.ctypes.data,
                     sq.ctypes.data)
    return lib


def _permute_cols(cols: list[int], is_q: bool) -> list[int]:
    """P or Q on a state given as 8 column ints."""
    a = _Cols(*cols)
    _native_lib().groestl_permute(a, int(is_q))
    return list(a)


def _compress_cols(h: list[int], m: list[int]) -> list[int]:
    """f(h, m) = P(h ^ m) ^ Q(m) ^ h on column ints."""
    a = _Cols(*h)
    _native_lib().groestl_compress(a, _Cols(*m))
    return list(a)


def compress_seq_native(h: list[int], blocks: bytes) -> list[int]:
    """Absorb len(blocks) // 64 blocks into the column state h."""
    a = _Cols(*h)
    _native_lib().groestl_compress_seq(a, blocks, len(blocks) // 64)
    return list(a)


def _digest_cols(h: list[int], tail: bytes) -> bytes:
    """Compress the padded tail's blocks into h, then the output transform."""
    a = _Cols(*h)
    out = ctypes.create_string_buffer(32)
    lib = _native_lib()
    lib.groestl_compress_seq(a, tail, len(tail) // 64)
    lib.groestl_output_transform(a, out)
    return out.raw


def groestl256(data: bytes) -> bytes:
    """One-shot Grøstl-256 digest."""
    data = bytes(data)
    out = ctypes.create_string_buffer(32)
    _native_lib().groestl_digest(_IV_COLS, data, len(data), out)
    return out.raw


def digest_rows_native(blobs: np.ndarray) -> np.ndarray:
    """Grøstl-256 of each row: (N, L) uint8 -> (N, 32) uint8."""
    blobs = np.ascontiguousarray(blobs, dtype=np.uint8)
    n, length = blobs.shape
    out = np.empty((n, 32), dtype=np.uint8)
    _native_lib().groestl_digest_batch(_IV_COLS, blobs.ctypes.data, n, length, out.ctypes.data)
    return out


hash_leaves_np = digest_rows_native


def compress_pairs(pairs: np.ndarray) -> np.ndarray:
    """Host 2-to-1 compression: (..., 64) uint8 numpy -> (..., 32) uint8."""
    flat = np.ascontiguousarray(pairs, dtype=np.uint8).reshape(-1, 64)
    out = np.empty((flat.shape[0], 32), dtype=np.uint8)
    _native_lib().groestl_compress_pairs(flat.ctypes.data, flat.shape[0], out.ctypes.data)
    return out.reshape(*np.shape(pairs)[:-1], 32)


class Groestl256:
    """Incremental Grøstl-256 (update / copy / finalize), the hash of the
    Fiat-Shamir challenger: the column state as 8 ints, the bytes of an
    unfinished block, the length so far."""

    def __init__(self):
        self._buf = bytearray()
        self._h = _bytes_to_cols(IV_256.tobytes())
        self._n_bytes = 0

    def update(self, data: bytes) -> "Groestl256":
        self._buf.extend(data)
        self._n_bytes += len(data)
        n_full = len(self._buf) // 64
        if n_full:
            self._h = compress_seq_native(self._h, bytes(self._buf[:64 * n_full]))
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
