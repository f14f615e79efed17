"""Sumcheck claims and round-polynomial helpers.

The port's copy of `binius_tpu/protocols/sumcheck/common.py`, which mirrors
`crates/core/src/protocols/sumcheck/common.rs`: claims over composite
polynomials of multilinears, round coefficient vectors in monomial basis, and
the truncated round proof (highest coefficient dropped; the verifier recovers
it from the running sum via s = r(0) + r(1), `common.rs:146-175`).
"""

from __future__ import annotations

import dataclasses

from ...fields import scalar
from ...math.arith import CompositionPoly

LEVEL = 7  # sumcheck runs over the 128-bit extension field


@dataclasses.dataclass(frozen=True)
class CompositeSumClaim:
    composition: CompositionPoly
    sum: int  # claimed sum over the hypercube (canonical int)


@dataclasses.dataclass(frozen=True)
class SumcheckClaim:
    n_vars: int
    n_multilinears: int
    composite_sums: tuple  # tuple[CompositeSumClaim]

    def max_individual_degree(self) -> int:
        return max((c.composition.degree() for c in self.composite_sums), default=0)


def add_coeffs(a: list[int], b: list[int]) -> list[int]:
    n = max(len(a), len(b))
    a = a + [0] * (n - len(a))
    return [x ^ (b[i] if i < len(b) else 0) for i, x in enumerate(a)]


def scale_coeffs(coeffs: list[int], c: int) -> list[int]:
    return [scalar.mul(LEVEL, c, x) for x in coeffs]


def truncate(coeffs: list[int]) -> list[int]:
    """RoundCoeffs -> RoundProof: drop the highest-degree coefficient."""
    return coeffs[:-1]


def recover_full(proof_coeffs: list[int], claimed_sum: int) -> list[int]:
    """Recover the truncated leading coefficient a_d from
    s = r(0) + r(1) = a_1 + ... + a_d  (char 2; a_0 cancels)."""
    acc = claimed_sum
    for c in proof_coeffs[1:]:
        acc ^= c
    return [*proof_coeffs, acc]


def eval_coeffs(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = scalar.mul(LEVEL, acc, x) ^ c
    return acc


def batch_weighted_sum(claims_sums: list[int], batch_coeffs: list[int]) -> int:
    """sum_i c_i s_i: the batched claim of several sumchecks."""
    acc = 0
    for s, c in zip(claims_sums, batch_coeffs):
        acc ^= scalar.mul(LEVEL, c, s)
    return acc
