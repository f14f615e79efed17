"""Arithmetic expressions for composition polynomials (the part the PIOP
reaches).

The port's subset of `binius_tpu/math/arith.py`: `ArithExpr` variables and
products, their degree and host evaluation on Python ints, and
`CompositionPoly` with `bivariate_product`. Device evaluation of general
expressions waits for the zerocheck slice.
"""

from __future__ import annotations

import dataclasses

from ..fields import scalar


@dataclasses.dataclass(frozen=True)
class ArithExpr:
    """Expression tree node; op in {'var', 'mul'}."""

    op: str
    args: tuple = ()
    value: int = 0      # var: index

    @staticmethod
    def var(index: int) -> "ArithExpr":
        return ArithExpr("var", (), index)

    def __mul__(self, other: "ArithExpr") -> "ArithExpr":
        return ArithExpr("mul", (self, other))

    def degree(self) -> int:
        if self.op == "var":
            return 1
        return sum(a.degree() for a in self.args)

    def evaluate_scalar(self, level: int, inputs: list) -> int:
        """Host evaluation on Python ints (verifier side)."""
        if self.op == "var":
            return inputs[self.value]
        return scalar.mul(level, self.args[0].evaluate_scalar(level, inputs),
                          self.args[1].evaluate_scalar(level, inputs))


@dataclasses.dataclass(frozen=True)
class CompositionPoly:
    """A composition C(P_0, ..., P_{m-1}) applied row-wise."""

    expr: ArithExpr
    n_vars: int  # number of input multilinears m

    def degree(self) -> int:
        return self.expr.degree()

    def evaluate_scalar(self, level: int, vals: list) -> int:
        return self.expr.evaluate_scalar(level, vals)


def bivariate_product() -> CompositionPoly:
    return CompositionPoly(ArithExpr.var(0) * ArithExpr.var(1), 2)
