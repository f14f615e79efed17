"""Transparent (verifier-evaluable) polynomials.

The port of `binius_tpu/protocols/transparent.py`: each polynomial
evaluates on host ints at a point (the verifier) and materializes its
multilinear on a device (the prover's witness): `Constant`,
`EqIndTransparent`, `MLEFromValues` (the pattern of a fixed column),
`StepDown` and `StepUp` (the padding masks of a table below its
power-of-two capacity), `StructuredArith` (a structured column: a
multilinear expression of the row index's bits), `Powers` (base^i at
index i), `SelectRow` (1 at one index), `TowerBasis` (the basis of a
tower extension) and `DisjointProduct` (the product of two of these over
disjoint variables).
"""

from __future__ import annotations

import dataclasses

import torch

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


@dataclasses.dataclass(frozen=True)
class StepDown:
    """1 on the hypercube indices below `index`, 0 from it on: the padding
    mask of a table of `index` rows in 2^n_vars."""

    n_vars: int
    index: int
    level: int = 0

    def evaluate_scalar(self, q: list[int]) -> int:
        """The MLE of [i < index], walking the bits from the high end: a
        0-bit of q where `index` has a 1 and the higher bits agree puts
        the row below `index`."""
        if self.index >= (1 << self.n_vars):
            return 1
        acc = 0
        prefix = 1   # eq(q, index) over the bits walked so far
        for k in reversed(range(self.n_vars)):
            if (self.index >> k) & 1:
                acc ^= scalar.mul(LEVEL, prefix, q[k] ^ 1)
                prefix = scalar.mul(LEVEL, prefix, q[k])
            else:
                prefix = scalar.mul(LEVEL, prefix, q[k] ^ 1)
        return acc

    def mle(self, device=None):
        rows = torch.arange(1 << self.n_vars, device=device)
        return 0, (rows < self.index).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class StepUp:
    """0 on the hypercube indices below `index`, 1 from it on."""

    n_vars: int
    index: int
    level: int = 0

    def evaluate_scalar(self, q: list[int]) -> int:
        return 1 ^ StepDown(self.n_vars, self.index).evaluate_scalar(q)

    def mle(self, device=None):
        rows = torch.arange(1 << self.n_vars, device=device)
        return 0, (rows >= self.index).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class StructuredArith:
    """A structured column: its value at hypercube index i is `expr` on the
    bits of i (var k = bit k, LSB first). The expression is multilinear,
    so its value at any point is the MLE's: the verifier evaluates it
    directly, and the prover materializes it over the index bits."""

    expr: object  # ArithExpr over n_vars index-bit variables, multilinear
    n_vars: int
    level: int = 7

    def __post_init__(self):
        assert _is_multilinear(self.expr), \
            "structured column expression must be multilinear in the index bits"

    def evaluate_scalar(self, q: list[int]) -> int:
        return self.expr.evaluate_scalar(LEVEL, list(q))

    def mle(self, device=None):
        iota = torch.arange(1 << self.n_vars, dtype=torch.int32, device=device)
        bits = [tower.embed(0, LEVEL, (iota >> i) & 1) for i in range(self.n_vars)]
        vals = self.expr.evaluate(LEVEL, bits)
        if self.level < LEVEL:
            return self.level, tower.split_to_subfield(LEVEL, self.level, vals)[..., 0]
        return LEVEL, vals


def _is_multilinear(expr) -> bool:
    """Degree <= 1 in every variable (products of distinct variables are
    multilinear)."""
    def degrees(e) -> dict:
        if e.op == "const":
            return {}
        if e.op == "var":
            return {e.value: 1}
        if e.op == "pow":
            return {k: v * e.value for k, v in degrees(e.args[0]).items()}
        left, right = degrees(e.args[0]), degrees(e.args[1])
        out = dict(left)
        for k, v in right.items():
            out[k] = max(out.get(k, 0), v) if e.op == "add" else out.get(k, 0) + v
        return out

    return all(v <= 1 for v in degrees(expr).values())


def incrementing_expr(max_size_log: int):
    """sum_i X_i * 2^i: the structured column of the row index."""
    from ..math.arith import ArithExpr

    e = None
    for i in range(max_size_log):
        term = ArithExpr.var(i) * ArithExpr.const(1 << i, 7)
        e = term if e is None else e + term
    return e


@dataclasses.dataclass(frozen=True)
class Powers:
    """base^i at hypercube index i: the multilinear prod_k (1 - x_k +
    x_k * base^(2^k))."""

    n_vars: int
    base: int
    level: int = 7

    def evaluate_scalar(self, q: list[int]) -> int:
        acc = 1
        b = self.base
        for k in range(self.n_vars):
            acc = scalar.mul(LEVEL, acc, 1 ^ scalar.mul(LEVEL, q[k], 1 ^ b))
            b = scalar.mul(LEVEL, b, b)
        return acc

    def mle(self, device=None):
        vals, cur = [], 1
        for _ in range(1 << self.n_vars):
            vals.append(cur)
            cur = scalar.mul(LEVEL, cur, self.base)
        return LEVEL, tower.from_ints(LEVEL, vals, device)


@dataclasses.dataclass(frozen=True)
class SelectRow:
    """1 at hypercube index `index`, 0 elsewhere: the MLE is
    eq(bits(index), X)."""

    n_vars: int
    index: int
    level: int = 0

    def __post_init__(self):
        assert 0 <= self.index < (1 << self.n_vars)

    def evaluate_scalar(self, q: list[int]) -> int:
        acc = 1
        for k in range(self.n_vars):
            acc = scalar.mul(LEVEL, acc, q[k] if (self.index >> k) & 1 else q[k] ^ 1)
        return acc

    def mle(self, device=None):
        rows = torch.arange(1 << self.n_vars, device=device)
        return 0, (rows == self.index).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class TowerBasis:
    """The basis of T_{iota+kappa} over T_iota: the value at hypercube
    index v is the basis element 1 << (v << iota)."""

    kappa: int
    iota: int

    @property
    def n_vars(self) -> int:
        return self.kappa

    @property
    def level(self) -> int:
        return self.iota + self.kappa

    def evaluate_scalar(self, q: list[int]) -> int:
        acc = 0
        for v in range(1 << self.kappa):
            term = 1 << (v << self.iota)
            for k in range(self.kappa):
                term = scalar.mul(LEVEL, term, q[k] if (v >> k) & 1 else q[k] ^ 1)
            acc ^= term
        return acc

    def mle(self, device=None):
        vals = [1 << (v << self.iota) for v in range(1 << self.kappa)]
        return self.level, tower.from_ints(self.level, vals, device)


@dataclasses.dataclass(frozen=True)
class DisjointProduct:
    """The product of two transparents over disjoint variables: poly0
    takes the low n0 variables, poly1 the high ones."""

    poly0: object
    poly1: object

    @property
    def n_vars(self) -> int:
        return self.poly0.n_vars + self.poly1.n_vars

    @property
    def level(self) -> int:
        return max(self.poly0.level, self.poly1.level)

    def evaluate_scalar(self, q: list[int]) -> int:
        n0 = self.poly0.n_vars
        return scalar.mul(LEVEL, self.poly0.evaluate_scalar(q[:n0]),
                          self.poly1.evaluate_scalar(q[n0:]))

    def mle(self, device=None):
        l0, d0 = self.poly0.mle(device)
        l1, d1 = self.poly1.mle(device)
        lvl = max(l0, l1, 5)   # products at B32 at least
        if l0 < lvl:
            d0 = tower.embed(l0, lvl, d0)
        if l1 < lvl:
            d1 = tower.embed(l1, lvl, d1)
        # index = i1 * 2^n0 + i0: poly1's value times poly0's
        n = 1 << self.n_vars
        a = d1.repeat_interleave(d0.shape[0], dim=0)
        b = d0.repeat((d1.shape[0],) + (1,) * (d0.dim() - 1))
        return lvl, tower.mul(lvl, a, b).reshape(tower.elem_shape(lvl, (n,)))
