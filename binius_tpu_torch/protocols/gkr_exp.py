"""GKR exponentiation: prove a column equals base^(bit-composed exponent).

The port of `binius_tpu/protocols/gkr_exp.py`. With bit columns
b_0..b_{n-1} (LSB first) and a base g (a public constant, static) or a
witness multilinear a (dynamic), the result column is
base^(sum_k 2^k b_k). An evaluation claim on the result walks down one
circuit layer per eq-indicator sumcheck and leaves evaluation claims on
the bit columns (and, for a dynamic base, on the base at every layer).

- static base g: V_{j+1} = V_j * (1 + b_j (1 + g^(2^j))), LSB first; the
  layer composition is eq * V * (1 + C_j b) with C_j = g^(2^j) + 1 a
  constant multilinear (its final evaluation is checked against C_j). The
  bottom layer V_1 = 1 + C_0 b_0 is linear in b_0: the last bit claim is
  recovered algebraically, with no sumcheck;
- dynamic base a: W_{j+1} = W_j^2 * (1 + b_{n-1-j} (1 + a)), MSB first;
  the layer composition is eq * W^2 * (1 + b (1 + a)), the last layer's
  eq * (1 + b (1 + a)).

The layer witnesses are a loop over the bits at the base's level, one
`tower.select` and one `tower.mul` per layer (static) or a
`tower.square` and a `tower.mul` (dynamic): at B64 and B128 each product
is one K1 launch on the card. Every layer is kept, as the walk reads them
top-down. Each walk step proves its claims' sumchecks as one batch
(`sumcheck.prove.batch_prove`), sorted by descending n_vars (stable).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..fields import scalar, tower
from ..math.arith import ArithExpr, CompositionPoly
from .sumcheck import prove as sc_prove
from .sumcheck import verify as sc_verify
from .sumcheck.common import LEVEL, CompositeSumClaim, SumcheckClaim


@dataclasses.dataclass(frozen=True)
class StaticExpClaim:
    """Claim: result (n_vars multilinear) = base^bits with n_bits bit
    columns; `eval_point` / `eval`: an evaluation claim on the result."""

    n_vars: int
    n_bits: int
    base: int
    eval_point: tuple
    eval: int


@dataclasses.dataclass(frozen=True)
class DynamicExpClaim:
    """Claim: result = a^bits, with a a witness multilinear."""

    n_vars: int
    n_bits: int
    eval_point: tuple
    eval: int


def _is_static(claim) -> bool:
    return isinstance(claim, StaticExpClaim)


@dataclasses.dataclass
class ExpWitness:
    """Layer witnesses of one exponentiation circuit: layers[j] is layer
    j + 1 ((2^n[, limbs]) at `level`), stacked; bits LSB first (level-0
    0/1 tensors); base = (level, data) for a dynamic base."""

    level: int
    n_vars: int
    layers: torch.Tensor  # (n_bits, 2^n[, limbs])
    bits: list
    base: tuple | None = None

    @property
    def result(self) -> torch.Tensor:
        return self.layers[-1]

    def layer(self, j: int) -> torch.Tensor:
        """Data of layer j (1-indexed: layer(1) is the first circuit layer)."""
        return self.layers[j - 1]

    @staticmethod
    def static(n_vars: int, base: int, bit_datas: list, level: int = LEVEL) -> "ExpWitness":
        dev = bit_datas[0].device
        one = tower.full(level, (), 1, dev)
        v = tower.full(level, (1 << n_vars,), 1, dev)
        layers = torch.empty((len(bit_datas), *v.shape), dtype=v.dtype, device=dev)
        g = base
        for j, b in enumerate(bit_datas):
            v = tower.mul(level, v, tower.select(level, b != 0, tower.full(level, (), g, dev), one))
            layers[j] = v
            g = scalar.square(level, g)
        return ExpWitness(level, n_vars, layers, list(bit_datas))

    @staticmethod
    def dynamic(n_vars: int, base: tuple, bit_datas: list, level: int = LEVEL) -> "ExpWitness":
        blvl, bdata = base
        if blvl < level:
            bdata = tower.embed(blvl, level, bdata)
        dev = bdata.device
        one = tower.full(level, (), 1, dev)
        w = tower.full(level, (1 << n_vars,), 1, dev)
        layers = torch.empty((len(bit_datas), *w.shape), dtype=w.dtype, device=dev)
        for j, b in enumerate(reversed(bit_datas)):
            w = tower.mul(level, tower.square(level, w), tower.select(level, b != 0, bdata, one))
            layers[j] = w
        return ExpWitness(level, n_vars, layers, list(bit_datas), (level, bdata))


# The layer compositions are shared across layers and claims; the static
# constant C_j enters as a constant multilinear, whose claimed evaluation
# the verifier checks against C_j.
@functools.lru_cache(maxsize=None)
def _static_layer_comp() -> CompositionPoly:
    """eq * V * (1 + C * b): vars (eq, V, b, C)."""
    eq, v, b, c = (ArithExpr.var(i) for i in range(4))
    return CompositionPoly(eq * (v * (ArithExpr.const(1) + c * b)), 4)


@functools.lru_cache(maxsize=None)
def _dynamic_layer_comp() -> CompositionPoly:
    """eq * W^2 * (1 + b * (1 + a)): vars (eq, W, b, a)."""
    eq, w, b, a = (ArithExpr.var(i) for i in range(4))
    return CompositionPoly(eq * (w * w * (ArithExpr.const(1) + b * (ArithExpr.const(1) + a))), 4)


@functools.lru_cache(maxsize=None)
def _dynamic_last_comp() -> CompositionPoly:
    """eq * (1 + b * (1 + a)): vars (eq, b, a)."""
    eq, b, a = (ArithExpr.var(i) for i in range(3))
    return CompositionPoly(eq * (ArithExpr.const(1) + b * (ArithExpr.const(1) + a)), 3)


@dataclasses.dataclass
class ExpOutput:
    bit_claims: list   # per claim: [(bit index, point, eval)]
    base_claims: list  # per claim: [(point, eval)] on the dynamic base


def _layer_no(claim, k_down: int) -> int:
    """The circuit layer walk step k_down reaches (the top layer first)."""
    return claim.n_bits - k_down


def _bit_index(claim, layer: int) -> int:
    """The exponent bit (LSB-first index) that layer `layer` consumes."""
    if _is_static(claim):
        return layer - 1
    return claim.n_bits - layer


def _static_c(claim, layer: int) -> int:
    return scalar.pow(LEVEL, claim.base, 1 << (layer - 1)) ^ 1


def _layer_claim(claim, layer: int, value: int) -> SumcheckClaim:
    if _is_static(claim):
        comp, n_mls = _static_layer_comp(), 4
    elif layer == 1:
        comp, n_mls = _dynamic_last_comp(), 3
    else:
        comp, n_mls = _dynamic_layer_comp(), 4
    return SumcheckClaim(claim.n_vars, n_mls, (CompositeSumClaim(comp, value),))


def batch_prove(claims: list, witnesses: list, transcript) -> ExpOutput:
    points = [list(c.eval_point) for c in claims]
    values = [c.eval for c in claims]
    bit_claims = [[] for _ in claims]
    base_claims = [[] for _ in claims]
    for k_down in range(max((c.n_bits for c in claims), default=0)):
        sc_claims, provers, metas = [], [], []
        for j, c in enumerate(claims):
            if c.n_bits <= k_down:
                continue
            w = witnesses[j]
            dev = w.layers.device
            layer = _layer_no(c, k_down)
            bits = (0, w.bits[_bit_index(c, layer)])
            if _is_static(c) and layer == 1:
                # the linear bottom layer: the bit's evaluation directly
                _static_first_layer(c, points[j], values[j], bit_claims[j])
                continue
            eq_ml = sc_prove.eq_ind_expansion_multilinear(points[j], dev)
            if _is_static(c):
                ck_ml = (LEVEL, tower.full(LEVEL, (1 << c.n_vars,), _static_c(c, layer), dev))
                mls = [eq_ml, (w.level, w.layer(layer - 1)), bits, ck_ml]
            elif layer == 1:
                mls = [eq_ml, bits, w.base]
            else:
                mls = [eq_ml, (w.level, w.layer(layer - 1)), bits, w.base]
            sc_claim = _layer_claim(c, layer, values[j])
            sc_claims.append(sc_claim)
            metas.append(j)
            provers.append(sc_prove.RegularSumcheckProver(
                sc_claim, mls, order_high=False, eq_ind_challenges=tuple(points[j])))
        if not provers:
            continue
        order = sorted(range(len(provers)), key=lambda i: -sc_claims[i].n_vars)
        out = sc_prove.batch_prove([provers[i] for i in order], transcript)
        del provers
        n_rounds = max(sc.n_vars for sc in sc_claims)
        for oi, evals in zip(order, out.multilinear_evals):
            j = metas[oi]
            _absorb_layer_evals(claims[j], k_down, evals,
                                sc_verify.claim_point(n_rounds, sc_claims[oi].n_vars,
                                                      out.challenges, False),
                                points, values, bit_claims, base_claims, j)
    return ExpOutput(bit_claims, base_claims)


def batch_verify(claims: list, transcript) -> ExpOutput:
    points = [list(c.eval_point) for c in claims]
    values = [c.eval for c in claims]
    bit_claims = [[] for _ in claims]
    base_claims = [[] for _ in claims]
    for k_down in range(max((c.n_bits for c in claims), default=0)):
        sc_claims, eq_pts, metas = [], [], []
        for j, c in enumerate(claims):
            if c.n_bits <= k_down:
                continue
            layer = _layer_no(c, k_down)
            if _is_static(c) and layer == 1:
                _static_first_layer(c, points[j], values[j], bit_claims[j])
                continue
            sc_claims.append(_layer_claim(c, layer, values[j]))
            eq_pts.append(list(points[j]))
            metas.append(j)
        if not sc_claims:
            continue
        order = sorted(range(len(sc_claims)), key=lambda i: -sc_claims[i].n_vars)
        ver = sc_verify.batch_verify([sc_claims[i] for i in order], transcript, False,
                                     [eq_pts[i] for i in order])
        n_rounds = max(sc.n_vars for sc in sc_claims)
        for oi, evals in zip(order, ver.multilinear_evals):
            j = metas[oi]
            c = claims[j]
            if _is_static(c) and evals[3] != _static_c(c, _layer_no(c, k_down)):
                raise ValueError("exp layer constant evaluation mismatch")
            _absorb_layer_evals(c, k_down, evals,
                                sc_verify.claim_point(n_rounds, sc_claims[oi].n_vars,
                                                      ver.challenges, False),
                                points, values, bit_claims, base_claims, j)
    # every walk ends at its linear or last layer: nothing is left to check
    return ExpOutput(bit_claims, base_claims)


def _absorb_layer_evals(claim, k_down: int, evals, pt, points, values,
                        bit_claims, base_claims, j) -> None:
    """Record a walk step's bit (and base) claims; the layer below's claim
    is the next step's."""
    layer = _layer_no(claim, k_down)
    pt = tuple(pt)
    if _is_static(claim):
        _, v_eval, b_eval, _ = evals
    elif layer == 1:
        (_, b_eval, a_eval), v_eval = evals, None
    else:
        _, v_eval, b_eval, a_eval = evals
    bit_claims[j].append((_bit_index(claim, layer), pt, b_eval))
    if not _is_static(claim):
        base_claims[j].append((pt, a_eval))
    points[j] = list(pt)
    values[j] = v_eval


def _static_first_layer(claim, point, value, out_bit_claims) -> None:
    """V_1 = 1 + C_0 b_0 is linear: b_0(pt) = (V_1(pt) + 1) / C_0. No
    transcript interaction."""
    c0 = _static_c(claim, 1)
    b_eval = scalar.mul(LEVEL, value ^ 1, scalar.invert(LEVEL, c0))
    out_bit_claims.append((0, tuple(point), b_eval))

