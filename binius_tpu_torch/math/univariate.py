"""Univariate evaluation domains and Lagrange interpolation (host).

The port's copy of the Python-int part of `binius_tpu/math/univariate.py`
that the bivariate sumcheck reaches: round polynomials have degree 2, so
interpolation runs on the host.
"""

from __future__ import annotations

import dataclasses

from ..fields import scalar
from .binary_subspace import BinarySubspace


@dataclasses.dataclass(frozen=True)
class EvaluationDomain:
    """Finite evaluation domain: distinct points (ints) at tower `level`."""

    level: int
    points: tuple

    @staticmethod
    def from_subspace(level: int, size: int) -> "EvaluationDomain":
        """The first `size` points of the canonical binary subspace
        enumeration (0, 1, 2, ...)."""
        dim = max(1, (size - 1).bit_length())
        sub = BinarySubspace.with_dim(level, dim)
        return EvaluationDomain(level, tuple(sub.get(i) for i in range(size)))

    @property
    def size(self) -> int:
        return len(self.points)

    def interpolate(self, value_level: int, values: list[int]) -> list[int]:
        """Coefficients (low -> high degree) of the interpolating polynomial."""
        n = self.size
        assert len(values) == n
        coeffs = [0] * n
        for i in range(n):
            basis = [1]
            den = 1
            for j in range(n):
                if j == i:
                    continue
                nxt = [0] * (len(basis) + 1)
                for d, c in enumerate(basis):
                    nxt[d] ^= scalar.mul(value_level, c, self.points[j])
                    nxt[d + 1] ^= c
                basis = nxt
                den = scalar.mul(value_level, den, self.points[i] ^ self.points[j])
            w = scalar.mul(value_level, values[i], scalar.invert(value_level, den))
            for d, c in enumerate(basis):
                coeffs[d] ^= scalar.mul(value_level, w, c)
        return coeffs
