"""Ring switching (DP24 §4-5): reduce small-field evaluation claims on
committed multilinears to PIOP sumcheck claims on their packed
multilinears.

Counterpart of `binius_tpu/protocols/ring_switch.py` (which mirrors
`crates/core/src/ring_switch/` and `tensor_algebra.rs`):

  * tensor-algebra partial evaluations (one per claim, mixed per shared
    eval-point prefix) are sent and checked against the claimed evals;
  * row-batching challenges fold the tensor elements vertically into the
    sums of the reduced sumcheck claims;
  * the transparent multiplier is the ring-switch eq indicator
    A(v) = sum_u rowcoeff_u * coord_u(mix * eq(z_suffix, v))
    (`ring_switch/eq_ind.rs:41-149`).

A committed multilinear at tower level l with n variables has
kappa = 7 - l; its eval point splits into prefix (z_0..z_{kappa-1}) and
suffix; the packed multilinear has n - kappa variables. Bit-packed (P1)
witnesses stay packed on the device. The tensor algebra's B128 products run
in the native host library (`tower_mul_batch`, `native/b128.c`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..convert import ints_to_pairs, pairs_to_ints
from ..device import resolve
from ..fields import scalar, tower
from ..math import mle
from ..utils import tracing
from .piop import PIOPSumcheckClaim
from .sumcheck.common import LEVEL

_M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# Tensor algebra over (B_l, B128) on the host: (2^kappa, 2) uint64 pairs
# ---------------------------------------------------------------------------

def coord(level: int, e: int, j: int) -> int:
    """The j-th B_level coordinate of a B128 element (the basis of bit slices)."""
    w = 1 << level
    return (e >> (j * w)) & ((1 << w) - 1)


def from_coords(level: int, coords: list[int]) -> int:
    w = 1 << level
    out = 0
    for j, c in enumerate(coords):
        out |= c << (j * w)
    return out


@functools.lru_cache(maxsize=None)
def _coord_layout(level: int):
    """(limb, offset, mask) of the k = 2^(7 - level) coordinates."""
    w = 1 << level
    js = np.arange(128 // w, dtype=np.uint64)
    limb = ((js * w) // 64).astype(np.int64)
    off = ((js * w) % 64).astype(np.uint64)
    return limb, off, np.uint64(_M64 if w == 64 else (1 << w) - 1)


def _to_coords(level: int, m: np.ndarray) -> np.ndarray:
    """(k, 2) uint64 pairs -> (k, k) coordinate matrix C[i, j]."""
    limb, off, mask = _coord_layout(level)
    return (m[:, limb] >> off[None, :]) & mask


def _from_coords(level: int, C: np.ndarray) -> np.ndarray:
    limb, off, mask = _coord_layout(level)
    out = np.zeros((C.shape[0], 2), dtype=np.uint64)
    np.bitwise_or.at(out, (slice(None), limb), (C & mask) << off[None, :])
    return out


class TensorAlgElem:
    """2^kappa vertical B128 elements, kappa = 7 - level."""

    __slots__ = ("level", "_m")

    def __init__(self, level: int, elems):
        self.level = level
        self._m = elems if isinstance(elems, np.ndarray) else ints_to_pairs(elems)

    @property
    def elems(self) -> list:
        return pairs_to_ints(self._m)

    @property
    def kappa(self) -> int:
        return 7 - self.level

    @staticmethod
    def from_vertical(level: int, x: int) -> "TensorAlgElem":
        m = np.zeros((1 << (7 - level), 2), dtype=np.uint64)
        m[0] = (x & _M64, x >> 64)
        return TensorAlgElem(level, m)

    def add(self, other: "TensorAlgElem") -> "TensorAlgElem":
        assert self.level == other.level
        return TensorAlgElem(self.level, self._m ^ other._m)

    def scale_vertical(self, s: int) -> "TensorAlgElem":
        return TensorAlgElem(self.level, scalar.mul_pairs(
            LEVEL, self._m, ints_to_pairs([s] * len(self._m))))

    def transpose(self) -> "TensorAlgElem":
        C = _to_coords(self.level, self._m)
        return TensorAlgElem(self.level, _from_coords(self.level, np.ascontiguousarray(C.T)))

    def scale_horizontal(self, s: int) -> "TensorAlgElem":
        return self.transpose().scale_vertical(s).transpose()

    def fold_vertical(self, coeffs: list[int]) -> int:
        acc = 0
        for x, c in zip(self.transpose().elems, coeffs):
            acc ^= scalar.mul(LEVEL, x, c)
        return acc


# ---------------------------------------------------------------------------
# Claims and host helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RingSwitchEvalClaim:
    """Evaluation claim on a committed small-field multilinear; `point` has
    packed_n_vars + kappa B128 coordinates."""

    committed_idx: int   # index into the commit metadata ordering
    level: int           # tower level of the committed multilinear
    point: tuple
    eval: int

    @property
    def kappa(self) -> int:
        return 7 - self.level

    @property
    def prefix(self) -> tuple:
        return self.point[:self.kappa]

    @property
    def suffix(self) -> tuple:
        return self.point[self.kappa:]


def _witness_n_vars(level: int, data: torch.Tensor) -> int:
    """log2 of the element count (bits, for bit-packed B1)."""
    return (tower.p1_n_elems(level, data) - 1).bit_length()


def _group_by(values):
    """Group equal values in first-seen order -> (uniques, index of each)."""
    uniq, idx = [], []
    for v in values:
        if v not in uniq:
            uniq.append(v)
        idx.append(uniq.index(v))
    return uniq, idx


def _eq_expansion_scalar(point: list[int]) -> list[int]:
    out = [1]
    for r in point:
        out = [scalar.mul(LEVEL, c, r ^ 1) for c in out] + [scalar.mul(LEVEL, c, r) for c in out]
    return out


def _mixing_coeffs(transcript, n_claims: int) -> list[int]:
    m = (n_claims - 1).bit_length() if n_claims > 1 else 0
    return _eq_expansion_scalar(transcript.sample_scalars(LEVEL, m))[:n_claims]


# ---------------------------------------------------------------------------
# The ring-switch eq indicator
# ---------------------------------------------------------------------------

def ring_switch_eq_ind_eval(level: int, suffix: list[int], mix: int,
                            row_coeffs: list[int], query: list[int]) -> int:
    """Host evaluation of A at a B128 query point (`ring_switch/eq_ind.rs:160-186`)."""
    assert len(query) == len(suffix)
    acc = TensorAlgElem.from_vertical(level, mix)
    for z, q in zip(suffix, query):
        acc = acc.add(acc.scale_vertical(z)).add(acc.scale_horizontal(q))
    return acc.fold_vertical(row_coeffs)


def _ta_transpose(level: int, a: torch.Tensor) -> torch.Tensor:
    """Swap the tensor factors of batched tensor-algebra elements
    (n, 2^kappa, 4): each element's coordinate matrix transposes."""
    coords = tower.split_to_subfield(LEVEL, level, a)
    return tower.join_from_subfield(LEVEL, level, coords.transpose(1, 2))


def _fold_vertical_batch(level: int, elems: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """Batched `TensorAlgElem.fold_vertical`: elems (n, 2^kappa, 4), rc
    (2^kappa, 4) -> (n, 4)."""
    return tower.inner_product(LEVEL, _ta_transpose(level, elems), rc[None], axis=1)


def ring_switch_eq_ind_eval_batch(level: int, suffixes: list, mixes: list[int],
                                  row_coeffs: list[int], query: list[int],
                                  device=None) -> list[int]:
    """A for many claims (one level, one suffix length) at one shared query
    point. The algebra is commutative, so the mixing coefficient
    (mix (x) 1) commutes through every step: the k-step product
    P_s = prod_i (1 + z_i (x) 1 + 1 (x) q_i) runs once per distinct suffix,
    and a claim's value is fold_vertical((mix (x) 1) * P_s)."""
    dev = resolve(device)
    uniq, sel = _group_by([tuple(s) for s in suffixes])
    k = len(query)
    zs = tower.from_ints(LEVEL, [s[j] for j in range(k) for s in uniq], dev)
    zs = zs.reshape(k, len(uniq), 4)
    qs = tower.from_ints(LEVEL, query, dev)
    acc = tower.zeros(LEVEL, (len(uniq), 1 << (7 - level)), dev)
    acc[:, 0] = tower.full(LEVEL, (len(uniq),), 1, dev)
    for j in range(k):
        vert = tower.mul(LEVEL, acc, zs[j][:, None])
        hztl = _ta_transpose(level, tower.mul(LEVEL, _ta_transpose(level, acc), qs[j]))
        acc = acc ^ vert ^ hztl
    per_claim = acc[torch.tensor(sel, dtype=torch.long, device=dev)]
    scaled = tower.mul(LEVEL, per_claim, tower.from_ints(LEVEL, mixes, dev)[:, None])
    rc = tower.from_ints(LEVEL, row_coeffs[:1 << (7 - level)], dev)
    return tower.to_ints(LEVEL, _fold_vertical_batch(level, scaled, rc))


class _BatchedEqIndEvals:
    """The verifier's transparent evaluations, one batched device call per
    (level, suffix length) group: the PIOP verifier queries every claim of a
    group at the same point, so the first query computes the whole group."""

    def __init__(self, claims, mixing, row_coeffs, device):
        self._row_coeffs = row_coeffs
        self._device = device
        self._groups: dict = {}
        self._members: dict = {}
        for i, (c, m) in enumerate(zip(claims, mixing)):
            key = (c.level, len(c.suffix))
            self._groups.setdefault(key, []).append((i, list(c.suffix), m))
            self._members[i] = key
        self._cache: dict = {}

    def eval(self, i: int, query: list[int]) -> int:
        key = (self._members[i], tuple(query))
        if key not in self._cache:
            members = self._groups[self._members[i]]
            vals = ring_switch_eq_ind_eval_batch(
                self._members[i][0], [s for _, s, _ in members], [m for _, _, m in members],
                self._row_coeffs, list(query), self._device)
            self._cache[key] = {j: v for (j, _, _), v in zip(members, vals)}
        return self._cache[key][i]


@functools.lru_cache(maxsize=None)
def _linear_map_tables(level: int, row_coeffs: tuple) -> np.ndarray:
    """The F2-linear map x -> A(x) = sum_u rc_u * embed(coord_u(x)) as 16
    byte tables: T[k, v] = A(v << 8k), (16, 256, 4) uint32. The map's image
    of bit b is rc_{b // w} * 2^(b % w) (w = 2^level)."""
    w = 1 << level
    img = [scalar.mul(LEVEL, row_coeffs[b // w], 1 << (b % w)) for b in range(128)]
    out = np.zeros((16, 256, 4), dtype=np.uint32)
    for kb in range(16):
        vals = [0] * 256
        for v in range(1, 256):
            low = v & -v
            vals[v] = vals[v ^ low] ^ img[8 * kb + low.bit_length() - 1]
        for limb in range(4):
            out[kb, :, limb] = [(x >> (32 * limb)) & 0xFFFFFFFF for x in vals]
    return out


def _apply_linear_map(tables: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """XOR over the 16 bytes of each B128 element x of tables[k, byte_k]."""
    out = torch.zeros_like(x)
    for kb in range(16):
        byte = (x[..., kb // 4] >> (8 * (kb % 4))) & 0xFF
        out ^= tables[kb][byte.long()]
    return out


def ring_switch_eq_ind_mle(level: int, suffix: list[int], mix: int, row_coeffs: list[int],
                           device=None):
    """(data, n_vars): the device multilinear of the ring-switch eq indicator."""
    dev = resolve(device)
    eq = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, suffix, dev))
    return _eq_ind_mle_batch(level, eq, tower.from_ints(LEVEL, [mix], dev),
                             row_coeffs)[0], len(suffix)


def _eq_ind_mle_batch(level: int, eq: torch.Tensor, mix: torch.Tensor,
                      row_coeffs: list[int]) -> torch.Tensor:
    """Eq-indicator multilinears of k claims over one suffix expansion:
    eq (2^n, 4), mix (k, 4) -> (k, 2^n, 4)."""
    tables = torch.from_numpy(_linear_map_tables(
        level, tuple(row_coeffs[:1 << (7 - level)])).view(np.int32).copy()).to(eq.device)
    return _apply_linear_map(tables, tower.mul(LEVEL, eq[None], mix[:, None]))


# ---------------------------------------------------------------------------
# Prove / verify
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReducedRingSwitch:
    sumcheck_claims: list   # [PIOPSumcheckClaim]
    transparent_mles: list  # prover: [(data, n_vars)]; verifier: [(n_vars, eval_fn)]


def prove(claims: list[RingSwitchEvalClaim], witnesses: list, transcript,
          device=None) -> ReducedRingSwitch:
    """witnesses[i] = (level, data) of committed multilinear i (level may be
    `tower.P1`); claims sorted ascending by packed n_vars. Runs on CUDA
    unless `device` names another. Claims group by (level, n_vars, suffix)
    for one partial evaluation each; the row-batch folds and transparents
    run per level and per (level, suffix). Two spans of `utils.tracing`:
    "host_algebra" (the mixing and row-batching coefficients) and
    "device_evals" (the partial evaluations, folds and transparents, and
    their read-backs)."""
    dev = resolve(device)
    witnesses = [(lvl, torch.as_tensor(d).to(dev)) for lvl, d in witnesses]
    n = len(claims)
    with tracing.span("host_algebra"):
        mixing = _mixing_coeffs(transcript, n)
    mix_dev = tower.from_ints(LEVEL, mixing, dev)

    eq_memo: dict = {}

    def eq_of(suffix):
        if suffix not in eq_memo:
            eq_memo[suffix] = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, suffix, dev))
        return eq_memo[suffix]

    levels = sorted({c.level for c in claims})
    claims_of_level: dict = {lvl: [] for lvl in levels}
    pos_in_level = [0] * n
    for i, c in enumerate(claims):
        pos_in_level[i] = len(claims_of_level[c.level])
        claims_of_level[c.level].append(i)
    with tracing.span("device_evals"):
        # tensor-algebra partial evaluations, scaled by the mixing coefficients
        scaled_by_level: dict = {}
        for lvl in levels:
            idxs = claims_of_level[lvl]
            kappa = 7 - lvl
            groups: dict = {}
            for pos, i in enumerate(idxs):
                c = claims[i]
                w_lvl, w_data = witnesses[c.committed_idx]
                assert (0 if w_lvl == tower.P1 else w_lvl) == lvl
                groups.setdefault((len(c.point), c.suffix, w_lvl, _witness_n_vars(w_lvl, w_data)),
                                  []).append(pos)
            chunks, order = [], []
            for (nv, suffix, w_lvl, wit_n), poss in groups.items():
                stack = torch.stack([witnesses[claims[idxs[p]].committed_idx][1] for p in poss])
                if nv == kappa:
                    stack = tower.resolve_p1(w_lvl, stack)[1]
                    if wit_n < kappa:
                        # a column shorter than one packed element repeats to
                        # fill it (padded_packed_eval)
                        reps = [1] * stack.ndim
                        reps[1] = 1 << (kappa - wit_n)
                        stack = stack.repeat(*reps)
                    chunks.append(tower.embed(lvl, LEVEL, stack))
                else:
                    chunks.append(mle.batched_evaluate_partial_high(
                        w_lvl, stack, nv, eq_of(suffix), kappa)[1])
                order.extend(poss)
            inv = [0] * len(idxs)
            for p2, p in enumerate(order):
                inv[p] = p2
            tensors = torch.cat(chunks)[torch.tensor(inv, dtype=torch.long, device=dev)]
            mix_lvl = mix_dev[torch.tensor(idxs, dtype=torch.long, device=dev)]
            scaled_by_level[lvl] = tower.mul(LEVEL, tensors, mix_lvl[:, None, :])
        # mix per shared prefix; the tensor elements go to the transcript
        prefixes, claim_to_prefix = _group_by([c.prefix for c in claims])
        w = transcript.message()
        for pi in range(len(prefixes)):
            members = [i for i, p in enumerate(claim_to_prefix) if p == pi]
            lvl = claims[members[0]].level
            rows = scaled_by_level[lvl][torch.tensor([pos_in_level[i] for i in members],
                                                     dtype=torch.long, device=dev)]
            w.write_scalars(LEVEL, tower.to_ints(LEVEL, tower.xor_reduce(rows, 0)))

    # row-batching challenges and the vertical folds
    row_challenges = transcript.sample_scalars(LEVEL, max(c.kappa for c in claims))
    with tracing.span("host_algebra"):
        row_coeffs = _eq_expansion_scalar(row_challenges)
    row_batched = [0] * n
    with tracing.span("device_evals"):
        for lvl in levels:
            rc = tower.from_ints(LEVEL, row_coeffs[:1 << (7 - lvl)], dev)
            vals = tower.to_ints(LEVEL, _fold_vertical_batch(lvl, scaled_by_level[lvl], rc))
            for pos, i in enumerate(claims_of_level[lvl]):
                row_batched[i] = vals[pos]
    transcript.message().write_scalars(LEVEL, row_batched)

    # the transparents, grouped by (level, suffix)
    transparents: list = [None] * n
    tgroups: dict = {}
    for i, c in enumerate(claims):
        tgroups.setdefault((c.level, c.suffix), []).append(i)
    with tracing.span("device_evals"):
        for (lvl, suffix), idxs in tgroups.items():
            out = _eq_ind_mle_batch(lvl, eq_of(suffix),
                                    mix_dev[torch.tensor(idxs, dtype=torch.long, device=dev)],
                                    row_coeffs)
            for j, i in enumerate(idxs):
                transparents[i] = (out[j], len(suffix))
    sc = [PIOPSumcheckClaim(len(c.suffix), c.committed_idx, i, rb)
          for i, (c, rb) in enumerate(zip(claims, row_batched))]
    return ReducedRingSwitch(sc, transparents)


def verify(claims: list[RingSwitchEvalClaim], transcript, device=None) -> ReducedRingSwitch:
    """The verifier: host checks of the tensor elements and row-batched
    sums; the transparents' evaluations run batched on `device` (CUDA
    unless named) when the PIOP verifier asks for them."""
    dev = resolve(device)
    n = len(claims)
    mixing = _mixing_coeffs(transcript, n)
    prefixes, claim_to_prefix = _group_by([c.prefix for c in claims])
    kappa_by_prefix: dict = {}
    for c, pi in zip(claims, claim_to_prefix):
        assert kappa_by_prefix.setdefault(pi, c.kappa) == c.kappa
    expected = [0] * len(prefixes)
    for c, m, pi in zip(claims, mixing, claim_to_prefix):
        expected[pi] ^= scalar.mul(LEVEL, c.eval, m)
    r = transcript.message()
    tensor_elems = []
    for pi, prefix in enumerate(prefixes):
        k = kappa_by_prefix[pi]
        elems = r.read_scalars(LEVEL, 1 << k)
        cur = list(elems)   # the vertical elements' MLE at the prefix
        for z in prefix:
            cur = [cur[2 * i] ^ scalar.mul(LEVEL, cur[2 * i] ^ cur[2 * i + 1], z)
                   for i in range(len(cur) // 2)]
        if cur[0] != expected[pi]:
            raise ValueError("ring switch: tensor element mismatch with eval claims")
        tensor_elems.append(TensorAlgElem(7 - k, elems))
    row_challenges = transcript.sample_scalars(LEVEL, max(c.kappa for c in claims))
    row_coeffs = _eq_expansion_scalar(row_challenges)
    row_batched = transcript.message().read_scalars(LEVEL, n)
    mixed_rb = [0] * len(prefixes)
    for rb, pi in zip(row_batched, claim_to_prefix):
        mixed_rb[pi] ^= rb
    for t, want in zip(tensor_elems, mixed_rb):
        if t.fold_vertical(row_coeffs) != want:
            raise ValueError("ring switch: row-batched sum mismatch")
    batched = _BatchedEqIndEvals(claims, mixing, row_coeffs, dev)
    transparents = [(len(c.suffix), functools.partial(batched.eval, i))
                    for i, c in enumerate(claims)]
    sc = [PIOPSumcheckClaim(len(c.suffix), c.committed_idx, i, rb)
          for i, (c, rb) in enumerate(zip(claims, row_batched))]
    return ReducedRingSwitch(sc, transparents)
