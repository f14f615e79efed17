"""Arithmetic expressions for composition polynomials.

The port of `binius_tpu/math/arith.py`: `ArithExpr` trees (constants,
variables, sums, products, powers), their analysis (degree, variables,
tower level of the constants), the canonical token stream of the system
digest, and evaluation on host ints (the verifier) or on batched tensors
(the prover, one tower op per node, shared subtrees evaluated once).
`CompositionPoly` applies an expression row-wise to m multilinears.
"""

from __future__ import annotations

import dataclasses

from ..fields import scalar, tower


@dataclasses.dataclass(frozen=True)
class ArithExpr:
    """Expression tree node; op in {'const', 'var', 'add', 'mul', 'pow'}."""

    op: str
    args: tuple = ()
    value: int = 0      # const: field value; var: index; pow: exponent
    level: int = 0      # const: tower level of the constant

    # -- construction ------------------------------------------------------
    @staticmethod
    def const(value: int, level: int = 0) -> "ArithExpr":
        if level == 0 and value not in (0, 1):
            raise ValueError("level-0 constant must be 0/1")
        return ArithExpr("const", (), int(value), level)

    @staticmethod
    def var(index: int) -> "ArithExpr":
        return ArithExpr("var", (), index)

    def __add__(self, other):
        other = _coerce(other)
        if self.op == "const" and self.value == 0:
            return other
        if other.op == "const" and other.value == 0:
            return self
        return ArithExpr("add", (self, other))

    def __mul__(self, other):
        other = _coerce(other)
        if self.op == "const" and self.value == 1 and self.level == 0:
            return other
        if other.op == "const" and other.value == 1 and other.level == 0:
            return self
        return ArithExpr("mul", (self, other))

    def __pow__(self, e: int):
        return ArithExpr("pow", (self,), int(e))

    # -- analysis ----------------------------------------------------------
    def degree(self) -> int:
        d = self.__dict__.get("_degree")
        if d is not None:
            return d
        if self.op == "const":
            d = 0
        elif self.op == "var":
            d = 1
        elif self.op == "add":
            d = max(a.degree() for a in self.args)
        elif self.op == "mul":
            d = sum(a.degree() for a in self.args)
        elif self.op == "pow":
            d = self.args[0].degree() * self.value
        else:
            raise AssertionError(self.op)
        object.__setattr__(self, "_degree", d)
        return d

    def n_vars(self) -> int:
        if self.op == "var":
            return self.value + 1
        return max((a.n_vars() for a in self.args), default=0)

    def binary_tower_level(self) -> int:
        """Smallest tower level containing all constants."""
        if self.op == "const":
            lvl = self.level
            while lvl > 0 and self.value < (1 << (1 << (lvl - 1))):
                lvl -= 1
            return lvl
        return max((a.binary_tower_level() for a in self.args), default=0)

    def vars_used(self) -> set:
        if self.op == "var":
            return {self.value}
        out = set()
        for a in self.args:
            out |= a.vars_used()
        return out

    # -- evaluation --------------------------------------------------------
    def evaluate(self, level: int, inputs):
        """Evaluate over batched tensors at tower `level` (canonical layout),
        indexed by variable. Constants embed as their integers."""
        device = inputs[0].device if len(inputs) else None
        return _evaluate_node(self, level, inputs, {}, device)

    def evaluate_scalar(self, level: int, inputs: list) -> int:
        """Host evaluation on Python ints (verifier side)."""
        if self.op == "const":
            return self.value
        if self.op == "var":
            return inputs[self.value]
        if self.op == "add":
            return (self.args[0].evaluate_scalar(level, inputs)
                    ^ self.args[1].evaluate_scalar(level, inputs))
        if self.op == "mul":
            return scalar.mul(level, self.args[0].evaluate_scalar(level, inputs),
                              self.args[1].evaluate_scalar(level, inputs))
        if self.op == "pow":
            return scalar.pow(level, self.args[0].evaluate_scalar(level, inputs), self.value)
        raise AssertionError(self.op)

    def remap_vars(self, mapping: dict) -> "ArithExpr":
        """Rebuild with variable indices remapped, memoized per node so that
        shared subtrees stay shared (the canonical circuit emission follows
        object identity)."""
        memo: dict = {}

        def go(e):
            out = memo.get(id(e))
            if out is not None:
                return out
            if e.op == "var":
                out = ArithExpr.var(mapping[e.value])
            elif e.op == "const":
                out = e
            else:
                out = ArithExpr(e.op, tuple(go(a) for a in e.args), e.value, e.level)
            memo[id(e)] = out
            return out

        return go(self)

    def serialize_tokens(self) -> tuple:
        """Canonical token stream (for constraint-system digests)."""
        if self.op == "const":
            return ("c", self.level, self.value)
        if self.op == "var":
            return ("v", self.value)
        toks = (self.op, self.value)
        for a in self.args:
            toks = toks + a.serialize_tokens()
        return toks


def _evaluate_node(e: ArithExpr, level: int, inputs, cache: dict, device):
    """`ArithExpr.evaluate` of one node, each shared subtree once (`cache`,
    by node id). A module function, not a closure: a recursive closure is
    a reference cycle, which would keep every intermediate tensor of the
    evaluation alive until the cyclic garbage collector runs."""
    key = id(e)
    if key in cache:
        return cache[key]
    if e.op == "const":
        r = tower.full(level, (), e.value, device=device)
    elif e.op == "var":
        r = inputs[e.value]
    elif e.op == "add":
        r = (_evaluate_node(e.args[0], level, inputs, cache, device)
             ^ _evaluate_node(e.args[1], level, inputs, cache, device))
    elif e.op == "mul":
        r = tower.mul(level, _evaluate_node(e.args[0], level, inputs, cache, device),
                      _evaluate_node(e.args[1], level, inputs, cache, device))
    elif e.op == "pow":
        r = _pow(level, _evaluate_node(e.args[0], level, inputs, cache, device), e.value)
    else:
        raise AssertionError(e.op)
    cache[key] = r
    return r


def _pow(level: int, x, e: int):
    """x^e element-wise by square and multiply (x^0 = 1)."""
    out = None
    base = x
    while e:
        if e & 1:
            out = base if out is None else tower.mul(level, out, base)
        e >>= 1
        if e:
            base = tower.mul(level, base, base)
    if out is None:
        return tower.full(level, tower.batch_shape(level, x), 1, device=x.device)
    return out


def _coerce(x):
    if isinstance(x, ArithExpr):
        return x
    if isinstance(x, int):
        lvl = 0
        while x >= (1 << (1 << lvl)):
            lvl += 1
        return ArithExpr.const(x, lvl)
    raise TypeError(type(x))


@dataclasses.dataclass(frozen=True)
class CompositionPoly:
    """A composition C(P_0, ..., P_{m-1}) applied row-wise."""

    expr: ArithExpr
    n_vars: int  # number of input multilinears m

    def degree(self) -> int:
        return self.expr.degree()

    def evaluate_batch(self, level: int, rows):
        """rows: m tensors of equal batch shape -> tensor."""
        assert len(rows) >= self.n_vars
        return self.expr.evaluate(level, rows)

    def evaluate_scalar(self, level: int, vals: list) -> int:
        return self.expr.evaluate_scalar(level, vals)


def bivariate_product() -> CompositionPoly:
    return CompositionPoly(ArithExpr.var(0) * ArithExpr.var(1), 2)
