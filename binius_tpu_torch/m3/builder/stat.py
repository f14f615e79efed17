"""Table statistics: proving-cost estimates per table.

The port of `binius_tpu/m3/builder/stat.py`: committed and virtual bits
per row, the total flush count, and the zero constraints grouped by
(tower level, values per row) with their degree and evaluation cost;
`assert_zero_cost_approx` is bits * degree * multiplication cost summed
over the constraints.
"""

from __future__ import annotations

import dataclasses

from ...math.arith import ArithExpr


@dataclasses.dataclass
class EvalCost:
    """Operation counts of one evaluation of an expression."""

    n_adds: int = 0
    n_muls: int = 0
    n_squares: int = 0

    def mult_cost_approx(self) -> int:
        return self.n_muls + -(-self.n_squares // 5)


def eval_cost(expr: ArithExpr) -> EvalCost:
    c = EvalCost()
    stack = [expr]
    while stack:
        e = stack.pop()
        if e.op == "add":
            c.n_adds += 1
        elif e.op == "mul":
            c.n_muls += 1
        elif e.op == "pow":
            # square and multiply: bit length - 1 squarings, popcount - 1 products
            c.n_squares += max(0, e.value.bit_length() - 1)
            c.n_muls += max(0, bin(e.value).count("1") - 1)
        stack.extend(e.args)
    return c


@dataclasses.dataclass
class _Constraint:
    name: str
    degree: int
    cost: EvalCost


class TableStat:
    """The statistics of one table (`TableBuilder.stat()`)."""

    def __init__(self, table):
        self.name = table.name
        self.bits_per_row_committed = 0
        self.bits_per_row_virtual = 0
        for cd in table.columns:
            bits = (1 << cd.col.level) << cd.col.log_values_per_row
            if cd.kind in ("committed", "static_exp", "dynamic_exp"):
                self.bits_per_row_committed += bits
            else:
                self.bits_per_row_virtual += bits
        self.total_flush_count = sum(f[3] for f in table.flushes)
        # {tower_level: {log_vpr: [_Constraint]}}
        self.constraints: dict = {}
        for name, vpr, expr, _cols, _steps in table.zero_constraints:
            self.constraints.setdefault(7, {}).setdefault(vpr, []).append(
                _Constraint(name, expr.degree(), eval_cost(expr)))

    def assert_zero_cost_approx(self) -> int:
        cost = 0
        for level, per_v in self.constraints.items():
            for v_log2, cons in per_v.items():
                for c in cons:
                    # towers below B8 count as B8: the univariate skip
                    # evaluates the constraints over B8 at least
                    bits = max(1 << level, 8) << v_log2
                    cost += bits * c.degree * c.cost.mult_cost_approx()
        return cost

    def __str__(self) -> str:
        lines = [f"table '{self.name}':",
                 f"* bits per row: {self.bits_per_row_committed + self.bits_per_row_virtual}",
                 f"  committed: {self.bits_per_row_committed}",
                 f"  virtual: {self.bits_per_row_virtual}",
                 f"* total flush count: {self.total_flush_count}",
                 "* zero checks:"]
        for level in sorted(self.constraints):
            lines.append(f"  B{1 << level}:")
            for v_log2 in sorted(self.constraints[level]):
                lines.append(f"    values_per_row={1 << v_log2}:")
                for i, c in enumerate(self.constraints[level][v_log2]):
                    lines.append(f"      {i + 1}. {c.name}: deg={c.degree},"
                                 f"  #+={c.cost.n_adds}, #x={c.cost.n_muls},"
                                 f" #^2={c.cost.n_squares}")
        lines.append(f"Total approximate assert_zero costs: {self.assert_zero_cost_approx()}")
        return "\n".join(lines)
