"""Bitsliced additive NTT: butterfly stages on bit planes (K3, K4).

Counterpart of `binius_tpu/ntt/bitsliced_ntt.py`. With bit b of 32
consecutive elements in one word:

  * an XOR butterfly is a plane XOR;
  * the twiddle multiply is the bitsliced Karatsuba network with the twiddle
    as 0/~0 mask planes, expanded from one packed twiddle word per data word
    and stage (`_make_plan`), XORed with per-stage intra-word delta masks
    where the pair distance is below 32 elements (the LCH14 twiddle is
    F2-linear in its index);
  * a B32 twiddle scales higher-level data group by group (`_scale`).

On the card the trailing stages of a forward transform (leading of an
inverse) whose pair distance fits a shared-memory tile of `_TILE_WORDS`
words run fused in K3 (`csrc/ntt.cu`); the other (cross) stages run in
K4, up to `_CROSS_STAGES` consecutive ones fused per launch
(`_cross_runs`). `_stage_plain` is the plain version of both. The plan's
twiddle rows are the contract between a kernel and its plain version; they
do not depend on the split.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda_lib
from ..device import i32, shr
from ..fields import bitslice, bitslice_cuda
from .additive_ntt import NTTDomain

# K3 tile: words of one 32-plane group held in shared memory. 32 planes x
# 1024 words x 4 B = 128 KB of the 227 KB a block may use; 2048 would not fit.
_TILE_WORDS = 1024
# K4 run: at most this many cross stages fused in one launch. Its tile holds
# 32 planes x 2^s words of the run's index bits x 2^(10 - s) low words =
# 128 KB, whose plane rows are still a 32-byte sector (8 words) at s = 7.
_CROSS_STAGES = 7


@dataclasses.dataclass(frozen=True)
class _Stage:
    d_elems: int            # butterfly element distance 2^(i + log_x)
    deltas: tuple           # 2^tl uint32 delta masks for intra-word stages
                            # (bit p of deltas[b] = bit b of the twiddle's
                            # p-dependent part); () if word-aligned


@dataclasses.dataclass(frozen=True)
class _Plan:
    dl: int                 # data tower level
    tl: int                 # twiddle tower level
    inverse: bool
    n_words: int
    stages: tuple           # _Stage tuple, in execution order
    tile: int               # K3 tile words
    n_local: int            # trailing (forward) / leading (inverse) stages in K3


_PLAN_CACHE: dict = {}

# the least batch the bitsliced path takes: one full K3 tile (2^15 elements)
MIN_ELEMS = 32 * _TILE_WORDS


def supported(tw_level: int, data_level: int, n: int) -> bool:
    """Shapes the bitsliced transform takes: twiddles at B32 or below, data
    at B32 or above them, and a power-of-two batch of at least 2^15
    elements (the JAX package's `wants_dispatch` threshold), so that every
    admitted plan has K3's full 1024-word tile."""
    return (tw_level <= 5 and data_level >= max(5, tw_level) and n >= MIN_ELEMS
            and n & (n - 1) == 0)


def _make_plan(domain: NTTDomain, dl: int, shape: tuple, coset: int,
               coset_bits: int, skip_rounds: int, inverse: bool):
    """Returns (plan, tw_np [n_stages, W] uint32 per-word packed twiddles)."""
    log_x, log_y, log_z = shape
    tl = domain.level
    assert tl <= 5, "packed twiddles need tl <= 5 (FEncode is B32)"
    assert dl >= tl
    key = (domain.level, domain.subspace.basis, dl, shape, coset, coset_bits,
           skip_rounds, inverse)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    n = 1 << (log_x + log_y + log_z)
    W = n >> 5
    assert W >= 1, "bitsliced NTT needs >= 32 elements"
    base_round = domain.log_domain_size - (log_y + coset_bits)
    assert base_round >= 0, "domain too small"
    if inverse:
        stage_is = range(0, log_y - skip_rounds)
    else:
        stage_is = range(log_y - skip_rounds - 1, -1, -1)

    stages = []
    tw_rows = []
    warr = np.arange(W, dtype=np.uint64)
    for i in stage_is:
        r = base_round + i
        n_bits = log_y - 1 - i
        s = i + 1 + log_x              # element index shift to block index
        row = domain.s_evals[r]
        mask = np.uint64((1 << n_bits) - 1)
        # block index of each word's element 0 (element e = 32w + p)
        if s >= 5:
            j = (warr >> np.uint64(s - 5)) & mask
        else:
            j = (warr << np.uint64(5 - s)) & mask
        base = domain.twiddle(r, coset << n_bits) if coset_bits or coset else 0
        t = np.full(W, np.uint32(base & 0xFFFFFFFF), dtype=np.uint32)
        for b in range(min(n_bits, 64)):
            sel = ((j >> np.uint64(b)) & np.uint64(1)).astype(bool)
            if sel.any():
                t[sel] ^= np.uint32(row[b] & 0xFFFFFFFF)
        deltas = ()
        if (1 << (i + log_x)) < 32:
            # intra-word stage: twiddle(32w + p) = t[w] ^ delta(p >> s)
            dvals = []
            for p in range(32):
                jp = p >> s
                v = 0
                for b in range(5 - s):
                    if (jp >> b) & 1:
                        v ^= row[b]
                dvals.append(v)
            deltas = tuple(
                sum((((dvals[p] >> b) & 1) << p) for p in range(32))
                for b in range(1 << tl))
        stages.append(_Stage(1 << (i + log_x), deltas))
        tw_rows.append(t)

    tile = min(_TILE_WORDS, W)
    n_local = 0
    for st in (stages if inverse else list(reversed(stages))):
        if (st.d_elems >> 5) > tile // 2:
            break
        n_local += 1
    plan = _Plan(dl, tl, inverse, W, tuple(stages), tile, n_local)
    tw_np = np.stack(tw_rows) if tw_rows else np.zeros((0, W), dtype=np.uint32)
    _PLAN_CACHE[key] = (plan, tw_np)
    return plan, tw_np


# ---------------------------------------------------------------------------
# Shared algebra (plain PyTorch)
# ---------------------------------------------------------------------------

def _masks_from_packed(tl: int, tw: torch.Tensor, deltas: tuple) -> list:
    """Expand per-word packed twiddles into 2^tl bit-plane masks."""
    out = []
    for b in range(1 << tl):
        m = -((tw >> b) & 1)
        if deltas and deltas[b]:
            m = m ^ i32(deltas[b])
        out.append(m)
    return out


def _scale(tl: int, dl: int, masks: list, x: list) -> list:
    """Multiply level-`dl` planes by level-`tl` twiddle masks, group-wise."""
    step = 1 << tl
    out = []
    for g in range(1 << (dl - tl)):
        out.extend(bitslice._mul_bs(tl, masks, x[g * step:(g + 1) * step]))
    return out


def _intra_word_masks(d: int) -> tuple[int, int]:
    """mask_u = bits p with (p / d) even (u elements of each pair), as int32."""
    mu = sum(1 << p for p in range(32) if ((p // d) & 1) == 0)
    return i32(mu), i32(~mu)


def _butterfly_intra(plan: _Plan, st: _Stage, masks: list, x: list) -> list:
    d = st.d_elems
    mu, mv = _intra_word_masks(d)
    P = 1 << plan.dl
    if not plan.inverse:
        sc = _scale(plan.tl, plan.dl, masks, x)
        out = []
        for b in range(P):
            xu = x[b] ^ shr(sc[b] & mv, d)
            xv = x[b] ^ ((xu & mu) << d)
            out.append((xu & mu) | (xv & mv))
        return out
    xv = [x[b] ^ ((x[b] & mu) << d) for b in range(P)]
    full = [(x[b] & mu) | (xv[b] & mv) for b in range(P)]
    sc = _scale(plan.tl, plan.dl, masks, full)
    return [((x[b] ^ shr(sc[b] & mv, d)) & mu) | (xv[b] & mv) for b in range(P)]


def _stage_plain(plan: _Plan, st: _Stage, planes: torch.Tensor,
                 tw_words: torch.Tensor) -> torch.Tensor:
    """One butterfly stage on planes [P, W]: the plain version of K3 and K4."""
    P = 1 << plan.dl
    W = plan.n_words
    if st.d_elems < 32:
        masks = _masks_from_packed(plan.tl, tw_words, st.deltas)
        return torch.stack(_butterfly_intra(plan, st, masks, list(planes.unbind(0))))
    dw = st.d_elems >> 5
    nb = W // (2 * dw)
    x = planes.reshape(P, nb, 2, dw)
    u = list(x[:, :, 0].unbind(0))
    v = list(x[:, :, 1].unbind(0))
    masks = _masks_from_packed(plan.tl, tw_words.reshape(nb, 2, dw)[:, 0], ())
    if not plan.inverse:
        sc = _scale(plan.tl, plan.dl, masks, v)
        u = [u[b] ^ sc[b] for b in range(P)]
        v = [v[b] ^ u[b] for b in range(P)]
    else:
        v = [v[b] ^ u[b] for b in range(P)]
        sc = _scale(plan.tl, plan.dl, masks, v)
        u = [u[b] ^ sc[b] for b in range(P)]
    return torch.stack([torch.stack(u), torch.stack(v)], dim=2).reshape(P, W)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda_plan(plan: _Plan, planes: torch.Tensor, name: str) -> None:
    cuda_lib.check(planes, name, ndim=2, align=16)  # 16-byte copies in and out
    if plan.tl != 5 or plan.dl < 5:
        raise NotImplementedError(f"{name}: the kernel takes B32 twiddles on data >= B32")
    if tuple(planes.shape) != (1 << plan.dl, plan.n_words):
        raise ValueError(f"{name}: planes {tuple(planes.shape)} do not match the plan")


def ntt_local(plan: _Plan, first: int, planes: torch.Tensor,
              tw: torch.Tensor) -> torch.Tensor:
    """Stages plan.stages[first:first + plan.n_local] fused (K3). `tw` holds
    their twiddle rows [n_local, W]. The kernel updates a CUDA `planes` in
    place."""
    stages = plan.stages[first:first + plan.n_local]
    if not planes.is_cuda:
        for k, st in enumerate(stages):
            planes = _stage_plain(plan, st, planes, tw[k])
        return planes
    _check_cuda_plan(plan, planes, "ntt_local")
    cuda_lib.check(tw, "ntt_local tw", ndim=2, align=16)
    if plan.tile % 4 or tuple(tw.shape) != (plan.n_local, plan.n_words):
        raise ValueError(f"ntt_local: tile {plan.tile} (16-byte copies) or twiddles "
                         f"{tuple(tw.shape)} do not fit the kernel")
    meta = _local_meta(plan, first, planes.device)
    cuda_lib.call("k3_ntt_local", planes.data_ptr(), tw.data_ptr(), meta.data_ptr(),
                  len(stages), plan.n_words, 1 << (plan.dl - 5), plan.tile,
                  int(plan.inverse))
    return planes


def _cross_runs(plan: _Plan) -> list:
    """The cross stages (those K3 does not take) as K4 launches: (first, n)
    runs of consecutive stages in execution order, each of at most
    `_CROSS_STAGES`."""
    n_stages = len(plan.stages)
    lo, hi = (plan.n_local, n_stages) if plan.inverse else (0, n_stages - plan.n_local)
    return [(f, min(_CROSS_STAGES, hi - f)) for f in range(lo, hi, _CROSS_STAGES)]


def _cross_lo_bit(plan: _Plan, first: int, n: int) -> int:
    """log2 of the least word distance of the run plan.stages[first:first + n],
    checked to be what K4 runs: 1..`_CROSS_STAGES` stages at consecutive
    word distances, a forward run from its largest down, an inverse run
    from its least up."""
    dws = [st.d_elems >> 5 for st in plan.stages[first:first + n]]
    lo_bit = min(dws, default=1).bit_length() - 1
    want = [1 << (lo_bit + k) for k in range(n)]
    if (not 1 <= n <= _CROSS_STAGES or len(dws) != n or lo_bit < 3
            or dws != (want if plan.inverse else want[::-1])):
        raise ValueError(f"ntt_cross: stages at word distances {dws} are not one run")
    return lo_bit


def ntt_cross(plan: _Plan, first: int, n: int, planes: torch.Tensor,
              tw: torch.Tensor) -> torch.Tensor:
    """Cross stages plan.stages[first:first + n] fused in one pass (K4).
    `tw` holds their twiddle rows [n, W]. The kernel updates a CUDA
    `planes` in place."""
    stages = plan.stages[first:first + n]
    if not planes.is_cuda:
        for k, st in enumerate(stages):
            planes = _stage_plain(plan, st, planes, tw[k])
        return planes
    _check_cuda_plan(plan, planes, "ntt_cross")
    cuda_lib.check(tw, "ntt_cross tw", ndim=2)
    lo_bit = _cross_lo_bit(plan, first, n)
    if tuple(tw.shape) != (n, plan.n_words):
        raise ValueError(f"ntt_cross: twiddles {tuple(tw.shape)} do not match the run")
    cuda_lib.call("k4_ntt_cross", planes.data_ptr(), tw.data_ptr(), plan.n_words,
                  1 << (plan.dl - 5), lo_bit, n, int(plan.inverse))
    return planes


def _local_meta_np(plan: _Plan, first: int) -> np.ndarray:
    rows = []
    for st in plan.stages[first:first + plan.n_local]:
        deltas = st.deltas or (0,) * 32
        rows.append([st.d_elems] + [i32(d) for d in deltas])
    return np.asarray(rows, dtype=np.int32).reshape(-1, 33)


_DEV_CACHE: dict = {}


def _local_meta(plan: _Plan, first: int, device) -> torch.Tensor:
    key = ("meta", id(plan), first, str(device))
    if key not in _DEV_CACHE:
        _DEV_CACHE[key] = torch.from_numpy(_local_meta_np(plan, first)).to(device)
    return _DEV_CACHE[key]


def _dev_tw(plan: _Plan, tw_np: np.ndarray, device) -> torch.Tensor:
    """Per-plan twiddle stack on `device`, cached by plan (plans are interned)."""
    key = ("tw", id(plan), str(device))
    if key not in _DEV_CACHE:
        _DEV_CACHE[key] = torch.from_numpy(tw_np.view(np.int32).copy()).to(device)
    return _DEV_CACHE[key]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _run_planes(plan: _Plan, planes: torch.Tensor, tw_all: torch.Tensor) -> torch.Tensor:
    """The stage loop; on the card it updates `planes` in place."""
    first = 0 if plan.inverse else len(plan.stages) - plan.n_local
    if plan.inverse and plan.n_local:
        planes = ntt_local(plan, first, planes, tw_all[first:first + plan.n_local])
    for f, n in _cross_runs(plan):
        planes = ntt_cross(plan, f, n, planes, tw_all[f:f + n])
    if not plan.inverse and plan.n_local:
        planes = ntt_local(plan, first, planes, tw_all[first:])
    return planes


def transform_planes(domain: NTTDomain, planes: torch.Tensor, data_level: int,
                     shape: tuple, coset: int = 0, coset_bits: int = 0,
                     skip_rounds: int = 0, inverse: bool = False) -> torch.Tensor:
    """Run the transform on bitsliced planes [2^data_level, n/32] (not in place)."""
    plan, tw_np = _make_plan(domain, data_level, shape, coset, coset_bits,
                             skip_rounds, inverse)
    return _run_planes(plan, planes.clone(), _dev_tw(plan, tw_np, planes.device))


def transform(domain: NTTDomain, data: torch.Tensor, data_level: int, shape: tuple,
              coset: int = 0, coset_bits: int = 0, skip_rounds: int = 0,
              inverse: bool = False) -> torch.Tensor:
    """Packed-layout entry: bitslice (K2), transform (K3/K4), unslice (K2)."""
    plan, tw_np = _make_plan(domain, data_level, shape, coset, coset_bits,
                             skip_rounds, inverse)
    planes = bitslice_cuda.to_bitsliced(data_level, data.contiguous())
    planes = _run_planes(plan, planes, _dev_tw(plan, tw_np, data.device))
    return bitslice_cuda.from_bitsliced(data_level, planes)
