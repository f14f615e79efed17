"""Univariate evaluation domains, Lagrange interpolation, line extrapolation.

The port of `binius_tpu/math/univariate.py` without its native-C path:
`EvaluationDomain` (host Lagrange evaluation and interpolation of the
sumcheck round polynomials), Horner evaluation, and the barycentric
Lagrange evaluations of the univariate-skip zerocheck's domains, whose
scans run as tower products on a device.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..device import resolve
from ..fields import scalar, tower
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

    def lagrange_evals(self, value_level: int, z: int) -> list[int]:
        """L_i(z) for every point i, at the value level."""
        pts = self.points
        out = []
        for i, pi in enumerate(pts):
            num, den = 1, 1
            for j, pj in enumerate(pts):
                if j != i:
                    num = scalar.mul(value_level, num, z ^ pj)
                    den = scalar.mul(value_level, den, pi ^ pj)
            out.append(scalar.mul(value_level, num, scalar.invert(value_level, den)))
        return out

    def extrapolate(self, value_level: int, values: list[int], z: int) -> int:
        """The interpolating polynomial of `values` evaluated at z."""
        assert len(values) == self.size
        acc = 0
        for v, lz in zip(values, self.lagrange_evals(value_level, z)):
            acc ^= scalar.mul(value_level, v, lz)
        return acc

    def interpolate(self, value_level: int, values: list[int]) -> list[int]:
        """Coefficients (low -> high degree) of the interpolating polynomial."""
        n = self.size
        assert len(values) == n
        coeffs = [0] * n
        for v, basis in zip(values, self._lagrange_basis(value_level)):
            if v:
                for d, c in enumerate(basis):
                    coeffs[d] ^= scalar.mul(value_level, v, c)
        return coeffs

    @functools.lru_cache(maxsize=None)
    def _lagrange_basis(self, value_level: int) -> tuple:
        """Per point i, the coefficients of the Lagrange polynomial that is
        1 at point i and 0 at the others."""
        n = self.size
        out = []
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
            inv = scalar.invert(value_level, den)
            out.append(tuple(scalar.mul(value_level, inv, c) for c in basis))
        return tuple(out)


# ---------------------------------------------------------------------------
# Barycentric Lagrange evaluation for the large univariate-skip domains
# (d * 2^skip points): the weights are domain constants, and each challenge
# costs O(n) products with two multiplicative scans.
# ---------------------------------------------------------------------------

def _points_level(points: tuple) -> int:
    """Smallest tower level holding every point: the weights' products
    close there (subfields embed as the integer identity)."""
    top = max(points, default=0)
    lvl = 0
    while top >= 1 << (1 << lvl):
        lvl += 1
    return lvl


@functools.lru_cache(maxsize=None)
def barycentric_weights(points: tuple) -> tuple:
    """w_i = 1 / prod_{j != i} (x_i + x_j) as ints."""
    lvl = _points_level(points)
    out = []
    for i, xi in enumerate(points):
        den = 1
        for j, xj in enumerate(points):
            if j != i:
                den = scalar.mul(lvl, den, xi ^ xj)
        out.append(scalar.invert(lvl, den))
    return tuple(out)


def _scan_mul(t: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive product scan of (n, 4) B128 elements in log2(n) steps."""
    if reverse:
        t = t.flip(0)
    d = 1
    while d < t.shape[0]:
        t = torch.cat([t[:d], tower.mul(7, t[d:], t[:-d])])
        d *= 2
    return t.flip(0) if reverse else t


def lagrange_evals_device(points: tuple, z: int, device=None) -> torch.Tensor:
    """(n, 4) B128 tensor of the Lagrange basis evaluations L_i(z) over
    `points` (canonical ints), from exclusive prefix and suffix products of
    (z + x_j), so that z on a domain point needs no division."""
    points = tuple(points)
    dev = resolve(device)
    xs = tower.from_ints(7, points, dev)
    w = tower.from_ints(7, barycentric_weights(points), dev)
    t = tower.from_ints(7, [z], dev) ^ xs
    one = tower.full(7, (1,), 1, device=dev)
    pre = torch.cat([one, _scan_mul(t, False)[:-1]])
    suf = torch.cat([_scan_mul(t, True)[1:], one])
    return tower.mul(7, w, tower.mul(7, pre, suf))


def lagrange_evals_np(points: tuple, z: int) -> list[int]:
    """The same Lagrange evaluations as ints, computed on the CPU (the
    verifier's host path)."""
    return tower.to_ints(7, lagrange_evals_device(points, z, "cpu"))


def evaluate_univariate(level: int, coeffs: list[int], z: int) -> int:
    """Horner evaluation, coefficients low -> high."""
    acc = 0
    for c in reversed(coeffs):
        acc = scalar.mul(level, acc, z) ^ c
    return acc


def extrapolate_line_scalar(level: int, x0: int, x1: int, z: int) -> int:
    """x0 + (x1 - x0) * z on the host."""
    return x0 ^ scalar.mul(level, x0 ^ x1, z)
