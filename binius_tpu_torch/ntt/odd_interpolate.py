"""Interpolation over odd NTT domains (union of d cosets of a subspace).

The port of `binius_tpu/ntt/odd_interpolate.py`: recover the
novel-basis coefficients of a polynomial of degree < d * 2^ell from its
evaluations on the first d cosets of an ell-dimensional subspace — an
inverse NTT per coset followed by a strided multiply with the inverse of the
"novel Vandermonde" matrix X_j(w_i) built from twiddle values.

The univariate-skip zerocheck uses it to extend the round evaluations of a
claim of lower degree to the batch's domain
(`protocols/sumcheck/univariate_zerocheck.py`). Host scalars: d is small
by construction (O(d^2 2^ell) products).
"""

from __future__ import annotations

import dataclasses

from ..fields import scalar
from .additive_ntt import AdditiveNTT, NTTDomain


def _matrix_invert(level: int, m: list[list[int]]) -> list[list[int]]:
    """Gauss-Jordan over T_level; raises on singular input."""
    d = len(m)
    aug = [list(row) + [1 if i == j else 0 for j in range(d)]
           for i, row in enumerate(m)]
    for col in range(d):
        piv = next((r for r in range(col, d) if aug[r][col] != 0), None)
        if piv is None:
            raise ValueError("singular Vandermonde matrix")
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = scalar.invert(level, aug[col][col])
        aug[col] = [scalar.mul(level, x, inv) for x in aug[col]]
        for r in range(d):
            if r != col and aug[r][col] != 0:
                f = aug[r][col]
                aug[r] = [x ^ scalar.mul(level, f, y)
                          for x, y in zip(aug[r], aug[col])]
    return [row[d:] for row in aug]


@dataclasses.dataclass
class OddInterpolate:
    """Interpolator for domains of size d * 2^ell (d <= 2^coset_bits)."""

    domain: NTTDomain
    d: int
    ell: int
    coset_bits: int
    vandermonde_inverse: list

    @staticmethod
    def create(domain: NTTDomain, d: int, ell: int, coset_bits: int) -> "OddInterpolate":
        assert 1 <= d <= (1 << coset_bits)
        assert domain.log_domain_size >= ell + coset_bits
        level = domain.level
        # X_{2^j}(w_i) = What^{(ell)}_j(w_i) = twiddle(ell + j, i >> (j+1))
        # + bit_j(i) (shifted-basis identity, odd_interpolate.rs:113-117);
        # other columns fill in multiplicatively.
        x = [[0] * d for _ in range(d)]
        for i in range(d):
            x[i][0] = 1
        log_d = max(1, (d - 1).bit_length()) if d > 1 else 0
        for j in range(log_d):
            if (1 << j) >= d:
                break
            for i in range(d):
                x[i][1 << j] = domain.twiddle(ell + j, i >> (j + 1)) ^ ((i >> j) & 1)
            for k in range(1, min(1 << j, d - (1 << j))):
                for t in range(d):
                    x[t][k + (1 << j)] = scalar.mul(level, x[t][k], x[t][1 << j])
        return OddInterpolate(domain, d, ell, coset_bits,
                              _matrix_invert(level, x))

    def inverse_transform(self, values: list[int]) -> list[int]:
        """Evaluations on cosets 0..d-1 of the ell-dim subspace -> the
        d * 2^ell novel-basis coefficients."""
        d, ell = self.d, self.ell
        assert len(values) == d << ell
        level = self.domain.level
        ntt = AdditiveNTT(self.domain)
        data: list[int] = []
        for i in range(d):
            chunk = values[i << ell:(i + 1) << ell]
            data.extend(ntt.inverse_scalar(chunk, level, ell, coset=i,
                                           coset_bits=self.coset_bits))
        out = list(data)
        inv = self.vandermonde_inverse
        for stride in range(1 << ell):
            bases = [data[(i << ell) | stride] for i in range(d)]
            for i in range(d):
                acc = 0
                for j in range(d):
                    acc ^= scalar.mul(level, inv[i][j], bases[j])
                out[(i << ell) | stride] = acc
        return out
