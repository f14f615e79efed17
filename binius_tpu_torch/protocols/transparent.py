"""Transparent (verifier-evaluable) polynomials.

The port of part of `binius_tpu/protocols/transparent.py`: each polynomial
evaluates on host ints at a point (the verifier) and materializes its
multilinear on a device (the prover's witness). Ported: `Constant`,
`EqIndTransparent` and `MLEFromValues` (the pattern of a fixed column);
the JAX module's other kinds (step-down and step-up masks, structured
arithmetic, powers, select-row, tower basis, disjoint product) wait for
the front end's column kinds that make them.
"""

from __future__ import annotations

import dataclasses

from ..fields import scalar, tower
from ..math import mle as mle_mod

LEVEL = 7


@dataclasses.dataclass(frozen=True)
class Constant:
    n_vars: int
    value: int
    level: int = 7

    def evaluate_scalar(self, point: list[int]) -> int:
        return self.value

    def mle(self, device=None):
        return self.level, tower.full(self.level, (1 << self.n_vars,), self.value, device)


@dataclasses.dataclass(frozen=True)
class EqIndTransparent:
    """eq(fixed_point, X)."""

    point: tuple  # B128 ints
    level: int = 7

    @property
    def n_vars(self) -> int:
        return len(self.point)

    def evaluate_scalar(self, q: list[int]) -> int:
        acc = 1
        for a, b in zip(self.point, q):
            acc = scalar.mul(LEVEL, acc, scalar.mul(LEVEL, a, b) ^ scalar.mul(LEVEL, a ^ 1, b ^ 1))
        return acc

    def mle(self, device=None):
        return LEVEL, mle_mod.eq_ind_partial_eval(
            LEVEL, tower.from_ints(LEVEL, list(self.point), device))


@dataclasses.dataclass(frozen=True)
class MLEFromValues:
    """The multilinear extension of a short public vector of values."""

    values: tuple  # 2^n_vars ints at `level`
    level: int

    @property
    def n_vars(self) -> int:
        return (len(self.values) - 1).bit_length()

    def evaluate_scalar(self, q: list[int]) -> int:
        cur = [int(v) for v in self.values]
        for r in q:
            cur = [cur[2 * i] ^ scalar.mul(LEVEL, cur[2 * i] ^ cur[2 * i + 1], r)
                   for i in range(len(cur) // 2)]
        return cur[0]

    def mle(self, device=None):
        return self.level, tower.from_ints(self.level, list(self.values), device)
