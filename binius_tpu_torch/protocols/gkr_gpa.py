"""GKR grand-product argument (the binary-tree multiplication circuit).

The port of `binius_tpu/protocols/gkr_gpa.py`: for each instance a product
tree over its multilinear's hypercube values; the layer claims walk down
the tree through batched eq-indicator sumchecks of eq(r, y) * L(0, y) *
L(1, y), each followed by a line reduction with one sampled challenge,
until "the product of the values is p" becomes an evaluation claim on the
input multilinear.

Instances of one size are stacked: `GrandProductWitness` holds the trees
of m instances of n variables as one (m, 2^k, 4) B128 tensor per layer,
each layer one `tower.mul` (one K1 launch on the card) for the whole
stack. Every instance active in a layer runs a sumcheck of the layer's
k variables at the same point (the line challenges are shared, and an
instance is active from the first layer on), so a layer is one
`EqStackedSumcheckProver` over all of them, with one eq expansion: k
rounds of one host read each, where the JAX package runs one prover per
instance. The transcript is the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import scalar, tower
from ..math.arith import ArithExpr, CompositionPoly
from .sumcheck import prove as sc_prove
from .sumcheck import verify as sc_verify
from .sumcheck.common import LEVEL, CompositeSumClaim, SumcheckClaim


@dataclasses.dataclass(frozen=True)
class GrandProductClaim:
    n_vars: int
    product: int


@dataclasses.dataclass
class GrandProductWitness:
    """The product trees of m instances of `n_vars` variables: layers[k] is
    the (m, 2^k, 4) B128 stack of layer k, layers[n_vars] the inputs and
    layers[0] the products; layer_k[:, i] = layer_{k+1}[:, 2i] *
    layer_{k+1}[:, 2i + 1]."""

    n_vars: int
    layers: list

    @staticmethod
    def compute(n_vars: int, data: torch.Tensor) -> "GrandProductWitness":
        """`data`: one instance's (2^n, 4) B128 values or an (m, 2^n, 4)
        stack of m instances."""
        cur = data if data.ndim == 3 else data[None]
        assert cur.shape[1] == 1 << n_vars
        layers = [cur]
        for k in range(n_vars, 0, -1):
            cur = _pairwise_product(cur, k)
            layers.append(cur)
        layers.reverse()
        return GrandProductWitness(n_vars, layers)

    @property
    def n_instances(self) -> int:
        return self.layers[0].shape[0]

    @property
    def products(self) -> list[int]:
        return tower.to_ints(LEVEL, self.layers[0][:, 0])


def _pairwise_product(stack: torch.Tensor, k: int) -> torch.Tensor:
    """(m, 2^k, 4) -> (m, 2^(k-1), 4): the products of even and odd entries."""
    d = stack.reshape(stack.shape[0], 1 << (k - 1), 2, 4)
    return tower.mul(LEVEL, d[:, :, 0], d[:, :, 1])


_PROD_COMP = CompositionPoly(ArithExpr.var(0) * ArithExpr.var(1) * ArithExpr.var(2), 3)
_AB = ArithExpr.var(0) * ArithExpr.var(1)


@dataclasses.dataclass
class GPAOutput:
    """Reduced evaluation claims: per instance, (point, eval) on the input."""

    eval_points: list
    evals: list


def _line_reduce(active, evals, mu, pt, points, values) -> None:
    for j, (_, a_eval, b_eval) in zip(active, evals):
        values[j] = a_eval ^ scalar.mul(LEVEL, a_eval ^ b_eval, mu)
        points[j] = [mu, *pt]


def batch_prove(claims: list[GrandProductClaim], witnesses: list[GrandProductWitness],
                transcript) -> GPAOutput:
    """Claims sorted descending by n_vars; `witnesses` are stacks of equal
    n_vars that cover the claims in order (a stack of m instances serves
    the next m claims). Every instance's product must be its claim's."""
    assert all(claims[i].n_vars >= claims[i + 1].n_vars for i in range(len(claims) - 1))
    assert sum(w.n_instances for w in witnesses) == len(claims)
    max_n = claims[0].n_vars if claims else 0
    points: list[list[int]] = [[] for _ in claims]
    values: list[int] = [c.product for c in claims]
    for k in range(max_n):
        active = [j for j, c in enumerate(claims) if c.n_vars > k]
        assert all(points[j] == points[active[0]] for j in active)
        parts = [w.layers[k + 1] for w in witnesses if w.n_vars > k]
        layer = torch.cat(parts) if len(parts) > 1 else parts[0]    # (m, 2^(k+1), 4)
        m = layer.shape[0]
        assert m == len(active)
        # [A_0, B_0, A_1, B_1, ..., eq]: A(y) = L(0, y) the even entries, B the odd
        stack = torch.empty((2 * m + 1, 1 << k, 4), dtype=layer.dtype, device=layer.device)
        stack[:2 * m].view(m, 2, 1 << k, 4).copy_(layer.reshape(m, 1 << k, 2, 4).transpose(1, 2))
        stack[2 * m] = sc_prove.eq_ind_expansion_multilinear(points[active[0]], layer.device)[1]
        sc_claims = [SumcheckClaim(k, 3, (CompositeSumClaim(_PROD_COMP, values[j]),))
                     for j in active]
        prover = sc_prove.EqStackedSumcheckProver(
            sc_claims, _AB, stack, [(2 * i, 2 * i + 1) for i in range(m)], points[active[0]])
        del layer, stack
        out = sc_prove.batch_prove([prover], transcript)
        mu = transcript.sample_scalar(LEVEL)
        _line_reduce(active, out.multilinear_evals, mu,
                     sc_verify.claim_point(k, k, out.challenges, False), points, values)
    return GPAOutput([list(p) for p in points], list(values))


def batch_verify(claims: list[GrandProductClaim], transcript) -> GPAOutput:
    assert all(claims[i].n_vars >= claims[i + 1].n_vars for i in range(len(claims) - 1))
    max_n = claims[0].n_vars if claims else 0
    points: list[list[int]] = [[] for _ in claims]
    values: list[int] = [c.product for c in claims]
    for k in range(max_n):
        active = [j for j, c in enumerate(claims) if c.n_vars > k]
        sc_claims = [SumcheckClaim(k, 3, (CompositeSumClaim(_PROD_COMP, values[j]),))
                     for j in active]
        ver = sc_verify.batch_verify(sc_claims, transcript, False, [points[j] for j in active])
        mu = transcript.sample_scalar(LEVEL)
        _line_reduce(active, ver.multilinear_evals, mu,
                     sc_verify.claim_point(k, k, ver.challenges, False), points, values)
    return GPAOutput([list(p) for p in points], list(values))
