"""M3 table builder: typed columns over the core constraint system.

The port of the part of `binius_tpu/m3/builder/table.py` that a u32_add
table needs: tables own committed and shifted columns and zero
constraints, and `compile` lowers them to the core `ConstraintSystem`
with its sizeless symbolic form (whose canonical digest the proof observes
first). The JAX builder's other column kinds, flushes, non-zero columns
and size specs are not ported.

A column with 2^v values per row becomes an oracle with log_rows + v
variables; the value index takes the LOW v bits, the row index the high
bits.
"""

from __future__ import annotations

import dataclasses

from ...constraint_system import canonical as canon
from ...constraint_system import oracle as om
from ...constraint_system.system import ConstraintSet, ConstraintSystem
from ...math.arith import ArithExpr


@dataclasses.dataclass(frozen=True)
class Col:
    """Typed column handle: tower level + log2(values per row)."""

    table_id: int
    index: int
    level: int
    log_values_per_row: int
    name: str = ""


@dataclasses.dataclass
class _ColumnDef:
    col: Col
    kind: str                   # committed | shifted
    inner: object = None        # shifted: the inner Col
    shift_offset: int = 0
    shift_block_bits: int = 0
    shift_variant: str = ""


class TableBuilder:
    def __init__(self, table_id: int, name: str = ""):
        self.table_id = table_id
        self.name = name
        self.columns: list[_ColumnDef] = []
        self.zero_constraints: list = []   # (name, log_vpr, expr, cols, steps)

    def _new_col(self, level, log_vpr, name) -> Col:
        return Col(self.table_id, len(self.columns), level, log_vpr, name)

    def add_committed(self, name: str, level: int, log_values_per_row: int = 0) -> Col:
        c = self._new_col(level, log_values_per_row, name)
        self.columns.append(_ColumnDef(c, "committed"))
        return c

    def add_shifted(self, name: str, inner: Col, offset: int, block_bits: int,
                    variant: str) -> Col:
        assert block_bits <= inner.log_values_per_row, "shift block must fit within a row"
        c = self._new_col(inner.level, inner.log_values_per_row, name)
        self.columns.append(_ColumnDef(c, "shifted", inner=inner, shift_offset=offset,
                                       shift_block_bits=block_bits, shift_variant=variant))
        return c

    def assert_zero(self, name: str, cols: list, expr: ArithExpr, group: str = "") -> None:
        """expr is over var(i) = cols[i], all of one values-per-row. The
        constraints of one (table, values-per-row) partition lower into ONE
        constraint set (`group` is accepted and has no effect). The
        canonical circuit steps are taken here, while the expression tree's
        sharing of subtrees is the builder's."""
        vpr = cols[0].log_values_per_row
        assert all(c.log_values_per_row == vpr for c in cols)
        self.zero_constraints.append((name, vpr, expr, tuple(cols), canon.circuit_steps(expr)))


class M3ConstraintSystem:
    """Top-level builder: tables."""

    def __init__(self):
        self.tables: list[TableBuilder] = []
        self.n_channels = 0

    def add_table(self, name: str = "") -> TableBuilder:
        t = TableBuilder(len(self.tables), name)
        self.tables.append(t)
        return t

    def compile(self, table_log_rows: list[int]):
        """Lower with power-of-two row counts. Returns (ConstraintSystem,
        oracle_map), oracle_map[(table_id, col_index)] = oracle id."""
        oracles = om.OracleSet()
        oracle_map: dict = {}
        constraint_sets = []
        sym_oracles: list = []
        sym_csets: list = []
        assert len(table_log_rows) == len(self.tables)
        for t_idx, (t, log_rows) in enumerate(zip(self.tables, table_log_rows)):
            for cd in t.columns:
                col = cd.col
                n_vars = log_rows + col.log_values_per_row
                key = (t.table_id, col.index)
                nm = f"{t.name}.{col.name}"
                if cd.kind == "committed":
                    oracle_map[key] = oracles.add_committed(n_vars, col.level, nm)
                    variant = ("committed",)
                else:
                    inner_id = oracle_map[(t.table_id, cd.inner.index)]
                    oracle_map[key] = oracles.add_shifted(
                        inner_id, cd.shift_offset, cd.shift_block_bits, cd.shift_variant, nm)
                    variant = ("shifted", inner_id, cd.shift_offset, cd.shift_block_bits,
                               cd.shift_variant)
                sym_oracles.append(canon.SymbolicOracle(
                    nm, t_idx, col.log_values_per_row, col.level, variant))

            # one constraint set per partition, ascending values-per-row: the
            # used columns in declaration order, the constraints in call order
            for vpr in sorted({c.col.log_values_per_row for c in t.columns}):
                entries = [(name, expr, cols, steps)
                           for name, c_vpr, expr, cols, steps in t.zero_constraints
                           if c_vpr == vpr]
                if not entries:
                    continue
                used_idx: set = set()
                for _, expr, cols, _ in entries:
                    for i in expr.vars_used():
                        used_idx.add(cols[i].index)
                col_list = [cd.col for cd in t.columns
                            if cd.col.log_values_per_row == vpr and cd.col.index in used_idx]
                dense = {c.index: pos for pos, c in enumerate(col_list)}
                exprs, sym_constraints = [], []
                for name, expr, cols, steps in entries:
                    remap = {i: dense[c.index] for i, c in enumerate(cols)
                             if i in expr.vars_used()}
                    exprs.append(expr.remap_vars(remap))
                    sym_constraints.append(canon.SymbolicConstraint(
                        name, canon.remap_steps(steps, remap), ("zero",)))
                ids = tuple(oracle_map[(t.table_id, c.index)] for c in col_list)
                constraint_sets.append(ConstraintSet(log_rows + vpr, ids, tuple(exprs)))
                sym_csets.append(canon.SymbolicConstraintSet(t_idx, vpr, ids,
                                                             tuple(sym_constraints)))
        symbolic = canon.SymbolicSystem(
            tuple(sym_oracles), tuple(sym_csets), (), (), (), self.n_channels,
            tuple(("arbitrary",) for _ in self.tables))
        return ConstraintSystem(oracles, constraint_sets, [], self.n_channels, [],
                                symbolic=symbolic), oracle_map
