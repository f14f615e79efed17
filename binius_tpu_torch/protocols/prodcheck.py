"""Product check through the binary-tree GKR multiplication circuit.

The port of `binius_tpu/protocols/prodcheck.py`, the module that succeeds
`gkr_gpa` in the reference: `ProductCircuitLayers.compute` evaluates the
fan-in-2 multiplication gates layer by layer, pairing the low and high
HALVES of each layer (where `gkr_gpa` pairs even and odd entries), one
`tower.mul` per layer, and `prove` / `verify` walk the tree from the
output to the input with one eq-indicator sumcheck of eq(r, y) * A(y) *
B(y) per layer, the line challenge appended at the high position.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import scalar, tower
from ..math.arith import ArithExpr, CompositionPoly
from .sumcheck import prove as sc_prove
from .sumcheck import verify as sc_verify
from .sumcheck.common import LEVEL, CompositeSumClaim, SumcheckClaim


@dataclasses.dataclass
class ProductCircuitLayers:
    """layers[i] has 2^(i+1) elements; layers[-1] is the input multilinear."""

    layers: list
    product: int

    @staticmethod
    def compute(evals: torch.Tensor, n_vars: int) -> "ProductCircuitLayers":
        if (1 << n_vars) != int(evals.shape[0]):
            raise ValueError("input slice must have power of two length")
        if n_vars == 0:
            return ProductCircuitLayers([], tower.to_ints(LEVEL, evals)[0])
        outs = []
        cur = evals
        for k in range(n_vars, 0, -1):
            half = 1 << (k - 1)
            cur = tower.mul(LEVEL, cur[:half], cur[half:])
            outs.append(cur)
        return ProductCircuitLayers(list(reversed(outs[:-1])) + [evals],
                                    tower.to_ints(LEVEL, outs[-1])[0])


@dataclasses.dataclass(frozen=True)
class ProdcheckClaim:
    n_vars: int
    product: int


@dataclasses.dataclass
class ProdcheckOutput:
    """The reduced claim: the input multilinear is `eval` at `eval_point`."""

    eval_point: list
    eval: int


_PROD_COMP = CompositionPoly(ArithExpr.var(0) * ArithExpr.var(1) * ArithExpr.var(2), 3)


def _next(k: int, challenges, evals, mu: int):
    """(point, value) of the next layer's claim after layer k's sumcheck."""
    pt = sc_verify.claim_point(k, k, challenges, False)
    _, a_eval, b_eval = evals
    return [*pt, mu], a_eval ^ scalar.mul(LEVEL, a_eval ^ b_eval, mu)


def prove(claim: ProdcheckClaim, layers: ProductCircuitLayers, transcript) -> ProdcheckOutput:
    """Reduce the product claim to an evaluation claim on the input."""
    point: list[int] = []
    value = claim.product
    for k in range(claim.n_vars):
        layer = layers.layers[k]
        a, b = layer[:1 << k], layer[1 << k:]
        sc_claim = SumcheckClaim(k, 3, (CompositeSumClaim(_PROD_COMP, value),))
        prover = sc_prove.RegularSumcheckProver(
            sc_claim, [sc_prove.eq_ind_expansion_multilinear(point, layer.device),
                       (LEVEL, a), (LEVEL, b)], order_high=False,
            eq_ind_challenges=tuple(point))
        out = sc_prove.batch_prove([prover], transcript)
        mu = transcript.sample_scalar(LEVEL)
        point, value = _next(k, out.challenges, out.multilinear_evals[0], mu)
    return ProdcheckOutput(point, value)


def verify(claim: ProdcheckClaim, transcript) -> ProdcheckOutput:
    point: list[int] = []
    value = claim.product
    for k in range(claim.n_vars):
        sc_claim = SumcheckClaim(k, 3, (CompositeSumClaim(_PROD_COMP, value),))
        ver = sc_verify.batch_verify([sc_claim], transcript, False, [point])
        mu = transcript.sample_scalar(LEVEL)
        point, value = _next(k, ver.challenges, ver.multilinear_evals[0], mu)
    return ProdcheckOutput(point, value)
