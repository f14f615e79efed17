"""Vision Mark-32 hash over the canonical binary tower.

The port of `binius_tpu/hash/vision.py`, the counterpart of
`crates/hash/src/vision/{permutation,digest,compression}.rs`: an algebraic
sponge of 24 B32 words, 8 rounds of two inversion S-boxes and an
NTT-structured MDS layer each, rate 16 words and capacity 8, overwrite-mode
absorption with 0x80..0x01 padding (`digest.rs:26-101`).

The reference computes in the AES tower and converts at the sponge's edge;
this permutation runs conjugated into the canonical tower instead: the round
keys are canonical B32 (`constants.rs:82`); the 24x24 MDS matrix is derived
from the canonical NTT domain (iNTT at cosets 0-2, x/y/z mixing, forward NTT
at cosets 3-5, `permutation.rs:186-203`); the S-box affine layers (AES-basis
constants, `constants.rs:7-79`) conjugate to 32x32 F2 matrices through the
anchored AES <-> canonical isomorphism; inversion commutes with it.

`permute_scalar` (Python ints) is the ground truth. `permute_batch` runs a
(batch, 24) int32 state on a device: round keys by XOR, `tower.invert(5)`,
the affine map by `tower.apply_bitmatrix`, and the MDS layer as one B32
product of the (24, 24) matrix with the state broadcast to (batch, 24, 24),
`tower.mul(5)` (K1 on the card, its plain version on the CPU), reduced by
XOR. The golden digests of `digest.rs:367-407` pin the bytes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import i32, resolve
from ..fields import scalar, tower
from ..fields.isomorphism import aes_to_canonical_b8_matrix, canonical_to_aes_b8_matrix
from ..ntt.additive_ntt import AdditiveNTT, NTTDomain
from ..utils import tracing

NUM_ROUNDS = 8
RATE_AS_U32 = 16
RATE_AS_U8 = 64
PADDING_START = 0x80
PADDING_END = 0x01

# spec constants (`crates/hash/src/vision/constants.rs`): AFFINE_* are in the
# AES basis, ROUND_KEYS canonical B32

AFFINE_FWD_AES = (
    0x2D08EFEB, 0xF36CCD71, 0x0195E6C5, 0x65904C9F, 0x18B119FE, 0x72CA1F14,
    0xB14B611C, 0x3A669717, 0x4E9348DE, 0x408CB48B, 0x2403C51D, 0xE7BF2994,
    0xCFD293DF, 0x2E5F7F42, 0x42B307D4, 0x64A7E57A, 0x421B9978, 0x7B118F37,
    0x30AA893A, 0x3E021935, 0xF5EC09D5, 0xC18A0F95, 0x4FC4E3C3, 0x904B4C02,
    0xD15D6F2E, 0x8D185C7C, 0x504C17E3, 0x37E777C2, 0x30B10E92, 0x6E1A825A,
    0x6EA14C5C, 0x5A1B041F,
)

AFFINE_FWD_CONST_AES = 0x2C285AFF

AFFINE_INV_AES = (
    0x1AF256AB, 0xB00A31C8, 0xD0A45BAD, 0x28BA0E84, 0x981363AB, 0x52A94DCF,
    0x812F70AA, 0x41A33E37, 0x08EACB1B, 0x8C73B796, 0x0844BF00, 0x906FEC10,
    0xAAEEE482, 0xE2ED2212, 0x57F4EA4E, 0x6CF3B0CB, 0x0BD65B47, 0xFD84D24C,
    0x5E786C25, 0xDD3B0C42, 0xE0F38B73, 0x79593770, 0xD7E66F93, 0x9D32ED2C,
    0x7F6862A3, 0x07083CF2, 0x6AC71C0C, 0xC06890E3, 0xBF6F5D0A, 0xDDC3DFB0,
    0xF12411C0, 0x3CB53F46,
)

AFFINE_INV_CONST_AES = 0x6AD86F94

ROUND_KEYS = (
    (
        0x545E66A7, 0x073FDD58, 0x84362677, 0x95FE8565, 0x06269CD8, 0x9C17909E,
        0xF1F0ADEE, 0x2694C698, 0x94B2788F, 0x5EAC14AD, 0x21677A78, 0x5755730B,
        0x37CEF9CF, 0x2FB31FFE, 0xFC0082EC, 0x609C12F0, 0x102769EE, 0x4732860D,
        0xF97935E0, 0x36E77C02, 0xBA9E70DF, 0x67B701D7, 0x829D77A4, 0xF6EC454D,
    ),
    (
        0x73FA03E1, 0x2551A651, 0x0541031F, 0xEC1D59DC, 0x780F0B43, 0x04843F97,
        0xD379E20B, 0xBE4D1F58, 0xE4C2F8BB, 0xF29AEE17, 0x228E51F2, 0x840EE72B,
        0x0CB3B70E, 0xBACC914A, 0x490BFA7E, 0xC2C3018E, 0xF6D13BD2, 0x6A4D1FE1,
        0x4C2BC742, 0x4508CB46, 0xED63A2F1, 0x1802F859, 0xA00483B5, 0x56E12E78,
    ),
    (
        0xBACE7A4A, 0xC3A71400, 0x5A29B316, 0xEEDC8D26, 0x51C14D7E, 0x2ADD9BE8,
        0xFEC386F3, 0x630765DC, 0xAEF6C21B, 0x8C98FC1A, 0x3F9C4F9D, 0x399E7231,
        0xBA238B04, 0x787D67EC, 0x313AD8AF, 0xDD622AC3, 0xE0A8D9B8, 0xAA0E6306,
        0x29864574, 0x67EE41DA, 0x5502278D, 0xA92E20B1, 0x0FDC5328, 0x74DBEE7A,
    ),
    (
        0x8BD2F341, 0x59DC2758, 0x5146C720, 0x9DF43021, 0x0D1C49EA, 0x81D4B0A5,
        0xDBFAE4D1, 0xC3153118, 0x8A3AEC81, 0xEACD8854, 0xDD4B2576, 0x7DD5CEE9,
        0x5E9E77B7, 0x6B6EFD8D, 0xF11DB400, 0x0E6258B7, 0x37B3B6E3, 0xED884C61,
        0xB948717C, 0x3D7554CF, 0x42419311, 0x422D11D3, 0x5392B2E7, 0x79C1591D,
    ),
    (
        0x27DF48AE, 0x948BC10E, 0xCB079DC1, 0xED183A37, 0x81DCC076, 0x24CB0490,
        0x52D69FB8, 0x8B576666, 0x7499FE4D, 0x8F879E34, 0xCB11780A, 0x5E876B29,
        0xB72D96AB, 0xAC28E621, 0x18AECA7E, 0xF3D30BAF, 0xC7FCA53F, 0xF7B3281A,
        0xDAF5559F, 0x27ACA0B3, 0x9515D3EE, 0xA39FD2E1, 0xF61B52C2, 0x83EC5A0F,
    ),
    (
        0x89841F23, 0x8BD0C3E1, 0xDE2DD62B, 0x37799416, 0x558834C7, 0x939DF560,
        0xB1A9F457, 0xCB24DADB, 0x4F702A2A, 0x65AD5822, 0x7ECF577D, 0x728B4092,
        0x89E4FA7D, 0x10CD7556, 0x1DE77AB7, 0x2374C530, 0x95B289D4, 0xA6AD3862,
        0xC6B1A233, 0xAC501639, 0x3F6072A3, 0xF8AE7CC4, 0x622F4CF3, 0xF7CCF75B,
    ),
    (
        0xAEDF6AAC, 0xD64356B2, 0x1CBBA169, 0x688602AE, 0x6231B358, 0x1FBA8B86,
        0xF7B83F1C, 0x465C4050, 0x4403E74C, 0x5F51C2F3, 0x1B114A4D, 0x8F32BF48,
        0x87990CFC, 0x71B55CB1, 0x73083164, 0x2FBD58AE, 0x59BBCBBF, 0xB0DC1EBA,
        0xF2F169FF, 0x54CC93E8, 0x975CFC83, 0xBEFC67CF, 0xB841429B, 0xFF127D64,
    ),
    (
        0xD6561783, 0x88153C99, 0x1A04E141, 0x62631076, 0xB20B52A2, 0x1DF18264,
        0x05176F17, 0x505B2752, 0x914A71AA, 0x1B6CF96D, 0x5A8B3B59, 0x3AB885CC,
        0xED662F24, 0xA859F626, 0xD91136BB, 0x6DA2D95B, 0x043FD679, 0xB9E685E8,
        0xDF796FA5, 0x53FC28A3, 0x0C15DC77, 0x079255D2, 0x3373A2A0, 0xFC6B012E,
    ),
    (
        0xB3359FF0, 0xA471ACDC, 0x6AD3E18A, 0x4F012F65, 0xEBD4392F, 0x25D3AF23,
        0x7A68469C, 0xD479EA57, 0xB55B6450, 0x86EF0A15, 0xEEFD412F, 0xC8E98F30,
        0x61E0C12D, 0x36C4680C, 0xE818AB96, 0xFCB765F2, 0xCBB47FEA, 0xC9E202A8,
        0xC762CAEC, 0x366F08FD, 0x5E2F3A19, 0x242C8397, 0x638A0042, 0x63F1C9C5,
    ),
    (
        0x4E28A23C, 0xDBE6F0DB, 0x9CF4FAEB, 0x2FDE2616, 0x22DEDEA1, 0x08EF118E,
        0xD7F16AE2, 0xA13B30A8, 0x2CEB58C1, 0xCA587D86, 0xF6D54FCD, 0x9CD9F3F5,
        0x9B0F94A2, 0xDEDE0863, 0xA608EB2D, 0x4D3C4469, 0x53784235, 0x4CF6AA1E,
        0xCB6EC0D5, 0xF334B49E, 0xE5F7A67A, 0x989658A2, 0xA1A672CA, 0x6FB7ECED,
    ),
    (
        0x2BBDF7B8, 0xA8626256, 0xD95BF688, 0x43245A87, 0xC14AF030, 0x28E5933A,
        0x3AEB3E0D, 0x169F7DEA, 0x4CD4D1E4, 0x8DB556B5, 0xDD1A49EA, 0xE64EFF5D,
        0x8BD56648, 0x2C3422BE, 0x5CFFB53F, 0x6B7AAA6E, 0xC2A8D1AF, 0x7E79BED4,
        0xD0B08E51, 0x1861BA54, 0xB7D3C6B4, 0x6A9BD7CA, 0x129D3AA5, 0x809E9413,
    ),
    (
        0x52538D7D, 0xDD441420, 0x38A2E2D5, 0xCCD05F31, 0x2A49F3A6, 0xE533CC9B,
        0xA18DE92E, 0x495F684A, 0x0028E3AE, 0xD4072861, 0x370FD7A3, 0x728224BC,
        0xA8B6B3D7, 0xDADA7046, 0xEA9E71DF, 0x914F7D53, 0x9B796AC9, 0xE7F61A69,
        0x67A68F71, 0x7EB15CE6, 0xEB9AF9E1, 0xA75F54B1, 0x59210427, 0x75093378,
    ),
    (
        0x27866FEA, 0x3BD84DCA, 0x681D1D3A, 0xE7FB7496, 0x86FD9BF8, 0xC1F28786,
        0xB3F17A06, 0x60C43DBE, 0x16FEE1BE, 0xA8407554, 0xCA909E3B, 0xB1FC461C,
        0xD84D663E, 0x2E7D669B, 0x5B5B5A56, 0x6C53D090, 0x236707A6, 0x7F1F4E97,
        0xE95B23F3, 0x8CD1E3DD, 0x928F3212, 0x9C7C1C20, 0x00EEEBE3, 0xC0572F52,
    ),
    (
        0xD1504060, 0x005D8A96, 0x058E317A, 0x30D9D3C6, 0xA585AF56, 0x084C5111,
        0x498DA85E, 0x0149987D, 0xE130153B, 0x817CC725, 0x75F726B1, 0x23941339,
        0x1F26E9DD, 0xDB013723, 0x81F36069, 0xE4167BA1, 0x50D59F82, 0xBF011350,
        0x3AE71F42, 0x9966D041, 0xDBE09577, 0xA830B8F0, 0x0C018C2D, 0x08BEAB4F,
    ),
    (
        0x20898252, 0xAC8AA337, 0x5C5BBCAD, 0x2FA58F41, 0xF2446068, 0xFFF46A79,
        0x0B1980D8, 0x01B14C53, 0x4E432072, 0xFC610A31, 0x80BA5531, 0xC14507A5,
        0x2433C5D2, 0x8A461CF3, 0x187849CD, 0x3D4F51E8, 0x3D9CD125, 0xE15E09CA,
        0x8C6287C6, 0xFA0EC2F4, 0x65435F29, 0xD33A4F3D, 0xD61BB963, 0x991005F9,
    ),
    (
        0x00D80BD4, 0x3D8B3D56, 0xCC18A7A9, 0x0105E9BB, 0x71F0E736, 0x4CC71FA4,
        0x1A2EC96B, 0xE1B8B093, 0x329232AB, 0xB4285526, 0x02326FE9, 0xE79ACCAB,
        0xD893B618, 0x9BD74BD5, 0x2062577C, 0x94F82DA9, 0xB551D97A, 0x862483F0,
        0x5F8E4E3E, 0x098D5E44, 0xBE326102, 0x4F5F050E, 0x1BD571D5, 0xCDD8E583,
    ),
    (
        0x1B525E1B, 0x1CCCB851, 0x45B3C777, 0x63CC9153, 0xDFA0FD4A, 0x0CF20C06,
        0x72FDD2F3, 0xF9B6F564, 0x9552A62B, 0x1E848099, 0x3BA1A5A6, 0x17FF06E0,
        0x8CAE82ED, 0xB5B29FBC, 0x9322D5A6, 0x77F40C4C, 0x0843CE60, 0x86DDB97F,
        0xE5A12A04, 0x9BD65CD6, 0x1B16BEA6, 0xF4066CEE, 0xDCB3C788, 0x499B6483,
    ),
)


# -- derived canonical-tower constants ---------------------------------------

def _phi32(x: int) -> int:
    """Canonical B32 -> AES, the B8 isomorphism on each byte (the reference's
    SubfieldTransformer over the 8b subfield, `aes_field.rs:199-228`)."""
    m = canonical_to_aes_b8_matrix()
    out = 0
    for b in range(4):
        out |= scalar.apply_linmap(m, (x >> (8 * b)) & 0xFF) << (8 * b)
    return out


def _psi32(x: int) -> int:
    """AES -> canonical B32 (the inverse of _phi32)."""
    m = aes_to_canonical_b8_matrix()
    out = 0
    for b in range(4):
        out |= scalar.apply_linmap(m, (x >> (8 * b)) & 0xFF) << (8 * b)
    return out


@functools.lru_cache(maxsize=None)
def _affine_canonical(which: str) -> tuple[tuple[int, ...], int]:
    """An AES-basis affine layer conjugated into the canonical basis:
    col_j = psi(A_aes(phi(2^j))), const = psi(c_aes)."""
    cols_aes, const_aes = {
        "fwd": (AFFINE_FWD_AES, AFFINE_FWD_CONST_AES),
        "inv": (AFFINE_INV_AES, AFFINE_INV_CONST_AES),
    }[which]
    cols = tuple(_psi32(scalar.apply_linmap(cols_aes, _phi32(1 << j))) for j in range(32))
    return cols, _psi32(const_aes)


@functools.lru_cache(maxsize=None)
def _ntt_domain() -> NTTDomain:
    # log_h + 2 + log_rate = 3 + 2 + 1 (`permutation.rs:40-45`)
    return NTTDomain.create(3, 6)


@functools.lru_cache(maxsize=None)
def _mds_scalars() -> tuple[int, int, int]:
    """The x, y, z mixing scalars: subspace evaluations (`permutation.rs:176-182`)."""
    d = _ntt_domain()
    return d.twiddle(3, 1), d.twiddle(3, 2), d.twiddle(2, 1)


def _mds_apply_scalar(state: list[int], level: int) -> list[int]:
    """The MDS transform of a 24-vector through host NTTs (`permutation.rs:
    186-203`): iNTT of each 8-group at cosets 0..2, x/y/z mixing, forward
    NTT at cosets 3..5. The scalars are B8; `level` is the elements' (3 to
    derive the matrix, 5 for a state)."""
    ntt = AdditiveNTT(_ntt_domain())
    x, y, z = _mds_scalars()
    g = [ntt.inverse_scalar(state[8 * c:8 * c + 8], level, 3, coset=c, coset_bits=3)
         for c in range(3)]
    out = [[0] * 8 for _ in range(3)]
    for k in range(8):
        d0, d1, d2 = g[0][k], g[1][k], g[2][k]
        d1 ^= d0
        xv = scalar.mul(level, x, d1)
        d2 ^= xv ^ d0
        yv = scalar.mul(level, y, d1)
        zv = scalar.mul(level, z, d2)
        s0, s1 = d0, d1
        d0 ^= xv ^ d1 ^ d2
        d1 = s0 ^ yv ^ zv
        d2 = d1 ^ s1
        out[0][k], out[1][k], out[2][k] = d0, d1, d2
    res = []
    for c in range(3):
        res += ntt.forward_scalar(out[c], level, 3, coset=3 + c, coset_bits=3)
    return res


@functools.lru_cache(maxsize=None)
def _mds_matrix() -> np.ndarray:
    """(24, 24) canonical-B8 MDS matrix: column i is MDS(e_i)."""
    m = np.zeros((24, 24), dtype=np.uint32)
    for i in range(24):
        m[:, i] = _mds_apply_scalar([int(j == i) for j in range(24)], 3)
    return m


# -- the host permutation (Python ints): the ground truth ---------------------

def _sbox_scalar(state: list[int], which: str) -> list[int]:
    cols, const = _affine_canonical(which)
    return [scalar.apply_linmap(cols, scalar.invert(5, v) if v else 0) ^ const for v in state]


def permute_scalar(state: list[int]) -> list[int]:
    """The Vision32b permutation of 24 canonical-B32 ints
    (`permutation.rs:94-112`)."""
    st = [v ^ k for v, k in zip(state, ROUND_KEYS[0])]
    for r in range(NUM_ROUNDS):
        st = _sbox_scalar(st, "inv")
        st = _mds_apply_scalar(st, 5)
        st = [v ^ k for v, k in zip(st, ROUND_KEYS[1 + 2 * r])]
        st = _sbox_scalar(st, "fwd")
        st = _mds_apply_scalar(st, 5)
        st = [v ^ k for v, k in zip(st, ROUND_KEYS[2 + 2 * r])]
    return st


# -- the batched permutation on a device ---------------------------------------

_DEVICE_CONSTS: dict = {}


def _device_consts(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The round keys (17, 24) and the MDS matrix (1, 24, 24) as int32 on
    `device`."""
    key = str(device)
    if key not in _DEVICE_CONSTS:
        rk = np.asarray(ROUND_KEYS, dtype=np.uint32).view(np.int32)
        mds = _mds_matrix().astype(np.int32)[None]
        _DEVICE_CONSTS[key] = (torch.from_numpy(rk).to(device), torch.from_numpy(mds).to(device))
    return _DEVICE_CONSTS[key]


def _sbox_batch(st: torch.Tensor, which: str) -> torch.Tensor:
    """Inversion (0 -> 0), then the canonical affine map and its constant."""
    cols, const = _affine_canonical(which)
    return tower.apply_bitmatrix(5, cols, tower.invert(5, st)) ^ i32(const)


def _mds_batch(st: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """out[b, i] = sum_j mds[i, j] * st[b, j]: one B32 product of
    (batch, 24, 24) elements, reduced by XOR."""
    return tower.xor_reduce(tower.mul(5, mds, st[:, None, :]), -1)


def permute_batch(states: torch.Tensor, device=None) -> torch.Tensor:
    """The permutation of each row of a (batch, 24) int32 canonical-B32
    state, on CUDA unless `device` names another: 16 K1 launches on the
    card, one per MDS layer."""
    st = states.to(resolve(device))
    rk, mds = _device_consts(st.device)
    st = st ^ rk[0]
    for r in range(NUM_ROUNDS):
        st = _mds_batch(_sbox_batch(st, "inv"), mds) ^ rk[1 + 2 * r]
        st = _mds_batch(_sbox_batch(st, "fwd"), mds) ^ rk[2 + 2 * r]
    return st


# -- the sponge (`digest.rs`) ------------------------------------------------------

class VisionHasherDigest:
    """Streaming Vision-32 digest on the host: rate 64 bytes, overwrite-mode
    absorption, 0x80..0x01 padding, 32-byte output (`digest.rs:48-132`)."""

    def __init__(self):
        self.state = [0] * 24
        self.buffer = bytearray()

    def update(self, data: bytes) -> "VisionHasherDigest":
        self.buffer += data
        while len(self.buffer) >= RATE_AS_U8:
            block, self.buffer = self.buffer[:RATE_AS_U8], self.buffer[RATE_AS_U8:]
            self._absorb(bytes(block))
        return self

    def _absorb(self, block: bytes) -> None:
        # the block's little-endian u32 words overwrite the rate (`digest.rs:67-86`)
        for i in range(RATE_AS_U32):
            self.state[i] = int.from_bytes(block[4 * i:4 * i + 4], "little")
        self.state = permute_scalar(self.state)

    def finalize(self) -> bytes:
        pad = bytearray(RATE_AS_U8 - len(self.buffer))
        pad[0] |= PADDING_START
        pad[-1] |= PADDING_END
        self._absorb(bytes(self.buffer + pad))
        self.buffer = bytearray()
        return b"".join(v.to_bytes(4, "little") for v in self.state[:8])


def digest(data: bytes) -> bytes:
    return VisionHasherDigest().update(data).finalize()


def digest_many(msgs, device=None) -> np.ndarray:
    """Vision digests of n equal-length messages, batched on CUDA unless
    `device` names another (MultiDigest semantics, `digest.rs:173-353`):
    (n, L) uint8, a numpy array or a tensor, -> (n, 32) uint8 numpy. Each
    64-byte block is one `permute_batch` of all n states; a length that is
    a multiple of 64 takes a whole padding block."""
    dev = resolve(device)
    m = torch.as_tensor(msgs).to(dev)
    n, length = m.shape
    n_blocks = length // RATE_AS_U8 + 1
    padded = torch.zeros((n, n_blocks * RATE_AS_U8), dtype=torch.uint8, device=dev)
    padded[:, :length] = m
    padded[:, length] |= PADDING_START
    padded[:, -1] |= PADDING_END
    words = padded.view(torch.int32)          # little-endian u32 words
    states = torch.zeros((n, 24), dtype=torch.int32, device=dev)
    for b in range(n_blocks):
        states = permute_batch(torch.cat(
            [words[:, b * RATE_AS_U32:(b + 1) * RATE_AS_U32], states[:, RATE_AS_U32:]], dim=1),
            dev)
    tracing.count("readbacks")
    return states[:, :8].contiguous().view(torch.uint8).cpu().numpy()


class Vision32Compression:
    """2-to-1 compression of 32-byte digests: the Vision digest of their
    64-byte concatenation (`compression.rs:12-19`), batched on CUDA unless
    `device` names another."""

    def __init__(self, device=None):
        self.device = device

    def compress(self, a: bytes, b: bytes) -> bytes:
        return digest(a + b)

    def compress_batch(self, pairs) -> np.ndarray:
        """(n, 64) uint8 concatenated child pairs -> (n, 32) uint8 digests."""
        return digest_many(pairs, self.device)
