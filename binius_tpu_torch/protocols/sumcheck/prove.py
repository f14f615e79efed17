"""The bivariate-product sumcheck prover of the PIOP.

The port of `BivariateSumcheckProver` (`binius_tpu/protocols/sumcheck/
prove.py:649`) and its round helpers: claims whose composites are all
products of two multilinears, the shape of the PIOP's claims (the
reference's v3 `BivariateSumcheckProver`). The multilinears sit in one
(m, 2^n, 4) B128 stack on the device; a round evaluates every product at
X = 0, 1, 2 over the halves of the folding variable and XOR-reduces, and
the host interpolates the degree-2 round polynomials. The JAX package's
power-of-4 shape buckets and streamed chunks exist for XLA's compile cache
and program size and are not carried over.
"""

from __future__ import annotations

import torch

from ...fields import tower
from ...math import fold
from ...math.univariate import EvaluationDomain
from .common import LEVEL, SumcheckClaim


class BivariateSumcheckProver:
    """Prover for a claim whose composites are products of two of its
    multilinears; it folds the highest variable first."""

    def __init__(self, claim: SumcheckClaim, multilinears: list):
        assert len(multilinears) == claim.n_multilinears
        self.claim = claim
        self.n_remaining = claim.n_vars
        self.stack = torch.stack([tower.embed(lvl, LEVEL, d) for lvl, d in multilinears])
        idx_a, idx_b = [], []
        for cs in claim.composite_sums:
            expr = cs.composition.expr
            assert expr.op == "mul" and expr.args[0].op == "var" and expr.args[1].op == "var", \
                "BivariateSumcheckProver requires pure product compositions"
            idx_a.append(expr.args[0].value)
            idx_b.append(expr.args[1].value)
        dev = self.stack.device
        self.idx_a = torch.tensor(idx_a, dtype=torch.long, device=dev)
        self.idx_b = torch.tensor(idx_b, dtype=torch.long, device=dev)
        self.domain = EvaluationDomain.from_subspace(3, 3)

    @property
    def n_vars(self) -> int:
        return self.claim.n_vars

    def _halves(self):
        """(evals at X = 0, evals at X = 1) of the folding variable."""
        n = 1 << self.n_remaining
        return self.stack[:, :n // 2], self.stack[:, n // 2:n]

    def compute_round_polys(self) -> list[list[int]]:
        if not len(self.idx_a):
            return []
        e0, e1 = self._halves()
        two = tower.full(LEVEL, (), 2, device=self.stack.device)
        rows = []
        for e in (e0, e1, fold.extrapolate_line(LEVEL, e0, e1, two)):
            prod = tower.mul(LEVEL, e[self.idx_a], e[self.idx_b])
            rows.append(tower.xor_reduce(prod, 1))          # (n_comps, 4)
        flat = tower.to_ints(LEVEL, torch.stack(rows))      # (3, n_comps) row-major
        n_c = len(self.idx_a)
        return [self.domain.interpolate(LEVEL, [flat[p * n_c + ci] for p in range(3)])
                for ci in range(n_c)]

    def fold(self, challenge: int) -> None:
        ch = tower.from_ints(LEVEL, [challenge], device=self.stack.device)[0]
        e0, e1 = self._halves()
        self.stack = fold.extrapolate_line(LEVEL, e0, e1, ch)
        self.n_remaining -= 1

    def finish(self) -> list[int]:
        assert self.n_remaining == 0
        return tower.to_ints(LEVEL, self.stack[:, 0])
