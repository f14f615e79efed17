"""Zerocheck via eq-indicator sumcheck.

The port's copy of `binius_tpu/protocols/sumcheck/zerocheck.py`: reduces
"composition vanishes on the hypercube" claims to sumchecks of
eq(r, X) * C(P(X)) with claimed sum 0, the skip_rounds = 0 path of the
constraint-system prover (`univariate_zerocheck.py` is the other).
"""

from __future__ import annotations

import dataclasses

from ...math.arith import ArithExpr, CompositionPoly
from . import prove as sc_prove
from . import verify as sc_verify
from .common import LEVEL, CompositeSumClaim, SumcheckClaim


@dataclasses.dataclass(frozen=True)
class ZerocheckClaim:
    n_vars: int
    n_multilinears: int
    compositions: tuple  # tuple[CompositionPoly] that must vanish on the cube


def _eq_weighted(comp: CompositionPoly) -> CompositionPoly:
    shifted = comp.expr.remap_vars({i: i + 1 for i in range(comp.n_vars)})
    return CompositionPoly(ArithExpr.var(0) * shifted, comp.n_vars + 1)


def to_sumcheck_claim(zc: ZerocheckClaim) -> SumcheckClaim:
    return SumcheckClaim(
        zc.n_vars,
        zc.n_multilinears + 1,
        tuple(CompositeSumClaim(_eq_weighted(c), 0) for c in zc.compositions),
    )


def batch_prove(zc_claims: list[ZerocheckClaim], multilinears_per_claim: list,
                transcript, order_high: bool = False) -> sc_prove.BatchSumcheckOutput:
    """Sample zerocheck challenges, build eq-ind sumcheck provers, batch-prove.

    Claims must be sorted descending by n_vars.
    """
    max_n = zc_claims[0].n_vars if zc_claims else 0
    r = transcript.sample_scalars(LEVEL, max_n)
    provers = []
    for zc, mls in zip(zc_claims, multilinears_per_claim):
        eq_ml = sc_prove.eq_ind_expansion_multilinear(r[:zc.n_vars], mls[0][1].device)
        provers.append(sc_prove.RegularSumcheckProver(
            to_sumcheck_claim(zc), [eq_ml, *mls], order_high,
            eq_ind_challenges=tuple(r[:zc.n_vars])))
    return sc_prove.batch_prove(provers, transcript)


def batch_verify(zc_claims: list[ZerocheckClaim], transcript,
                 order_high: bool = False) -> sc_verify.VerifiedBatch:
    max_n = zc_claims[0].n_vars if zc_claims else 0
    r = transcript.sample_scalars(LEVEL, max_n)
    claims = [to_sumcheck_claim(zc) for zc in zc_claims]
    eq_points = [list(r[:zc.n_vars]) for zc in zc_claims]
    return sc_verify.batch_verify(claims, transcript, order_high, eq_points)
