"""Batched sumcheck verification (host).

The port's copy of `binius_tpu/protocols/sumcheck/verify.py`: walks the
transcript of `prove.batch_prove`, recovers the truncated round
polynomials, folds the running batched sum, and reduces each claim to
multilinear evaluation claims at the challenge point.
"""

from __future__ import annotations

import dataclasses

from ...fields import scalar
from . import common
from .common import LEVEL, SumcheckClaim


@dataclasses.dataclass
class VerifiedBatch:
    challenges: list
    multilinear_evals: list  # per claim (eq-ind eval reconstructed, included)


def claim_point(n_rounds: int, n_vars: int, challenges: list[int], order_high: bool) -> list[int]:
    """The evaluation point (var index order) for a claim of `n_vars` that
    activated at round n_rounds - n_vars."""
    act = n_rounds - n_vars
    chs = challenges[act:]
    if order_high:
        return list(reversed(chs))  # var j bound at round act + (n_vars-1-j)
    return list(chs)                # var j bound at round act + j


def batch_verify(claims: list[SumcheckClaim], transcript, order_high: bool,
                 eq_ind_points: list | None = None) -> VerifiedBatch:
    """Verify a front-loaded batch; claims sorted descending by n_vars.

    eq_ind_points[i] is the eq-indicator point for claim i (or None); for such
    claims multilinear 0's eval is computed by the verifier, not read.
    """
    if eq_ind_points is None:
        eq_ind_points = [None] * len(claims)
    assert all(claims[i].n_vars >= claims[i + 1].n_vars for i in range(len(claims) - 1))
    n_rounds = claims[0].n_vars if claims else 0
    batch_coeffs: list[int] = []
    challenges: list[int] = []
    batched_sum = 0
    next_idx = 0
    max_deg_active = 0
    for rnd in range(n_rounds):
        remaining = n_rounds - rnd
        while next_idx < len(claims) and claims[next_idx].n_vars == remaining:
            phi = transcript.sample_scalar(LEVEL)
            batch_coeffs.append(phi)
            for cs in claims[next_idx].composite_sums:
                batched_sum ^= scalar.mul(LEVEL, phi, cs.sum)
            max_deg_active = max(max_deg_active, claims[next_idx].max_individual_degree())
            next_idx += 1
        deg = max_deg_active
        proof_coeffs = transcript.message().read_scalars(LEVEL, max(deg, 0))
        full = common.recover_full(proof_coeffs, batched_sum)
        challenge = transcript.sample_scalar(LEVEL)
        challenges.append(challenge)
        batched_sum = common.eval_coeffs(full, challenge)
    while next_idx < len(claims) and claims[next_idx].n_vars == 0:
        phi = transcript.sample_scalar(LEVEL)
        batch_coeffs.append(phi)
        for cs in claims[next_idx].composite_sums:
            batched_sum ^= scalar.mul(LEVEL, phi, cs.sum)
        next_idx += 1
    # Final check: batched composite evaluation at the challenge point
    expected = 0
    all_evals = []
    eq_memo: dict = {}   # claims at one eq point (a grand-product layer) share its eq
    for i, (claim, phi) in enumerate(zip(claims, batch_coeffs)):
        n_send = claim.n_multilinears - (1 if eq_ind_points[i] is not None else 0)
        evals = transcript.message().read_scalars(LEVEL, n_send)
        if eq_ind_points[i] is not None:
            key = (tuple(eq_ind_points[i]), claim.n_vars)
            if key not in eq_memo:
                pt = claim_point(n_rounds, claim.n_vars, challenges, order_high)
                eq_memo[key] = _eq_scalar(eq_ind_points[i], pt)
            evals = [eq_memo[key], *evals]
        all_evals.append(evals)
        for cs in claim.composite_sums:
            expected ^= scalar.mul(LEVEL, phi, cs.composition.evaluate_scalar(LEVEL, evals))
    if expected != batched_sum:
        raise ValueError("sumcheck final composite check failed")
    return VerifiedBatch(challenges, all_evals)


def _eq_scalar(x: list[int], y: list[int]) -> int:
    assert len(x) == len(y)
    acc = 1
    for a, b in zip(x, y):
        acc = scalar.mul(LEVEL, acc, scalar.mul(LEVEL, a, b) ^ scalar.mul(LEVEL, a ^ 1, b ^ 1))
    return acc
