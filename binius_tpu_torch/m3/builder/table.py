"""M3 table builder: typed columns over the core constraint system.

The port of `binius_tpu/m3/builder/table.py`: tables own committed,
shifted, computed, constant, fixed, structured, exponent, packed and selected
columns, zero constraints, channel flushes (push and pull, with a multiplicity and a
selector column), non-zero columns and a size spec (arbitrary, power of
two, or fixed), and `compile_sizes` lowers them for given row counts to
the core `ConstraintSystem` with its sizeless symbolic form (whose
canonical digest the proof observes first). A computed column lowers to
a linear combination oracle when its expression is linear and to a
composite one otherwise; a constant or fixed column to a one-row
transparent repeated over the rows; a structured column to a
`StructuredArith` transparent of the row index's bits; an exponent
column (static or dynamic base) to a committed oracle that the prover
fills, and an `Exp` record. A table whose size spec is arbitrary gets a
`StepDown` selector on every flush, appended after the symbolic oracles,
so that its padding rows stay out of the channels. A packed column
(one value per row, the row's 2^v values joined) lowers to a packed
oracle, a selected column or block (one value, or a block of values, of
each row) to a B128 projected oracle whose bound values are the index's
bits.

A column with 2^v values per row becomes an oracle with log_rows + v
variables; the value index takes the LOW v bits, the row index the high
bits.
"""

from __future__ import annotations

import dataclasses

from ...constraint_system import canonical as canon
from ...constraint_system import oracle as om
from ...constraint_system.exp import Exp
from ...constraint_system.system import (PULL, PUSH, ConstraintSet, ConstraintSystem, Flush,
                                         NonZeroClaim)
from ...math.arith import ArithExpr
from ...protocols.transparent import Constant, MLEFromValues, StepDown, StructuredArith


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
    kind: str                   # committed | shifted | computed | constant | fixed
                                # | structured | static_exp | dynamic_exp | packed
                                # | selected
    inner: object = None        # shifted, packed and selected: the inner Col;
                                # computed and structured: the ArithExpr; fixed:
                                # the pattern; dynamic_exp: the base Col
    shift_offset: int = 0
    shift_block_bits: int = 0   # shifted: the block bits; selected: log2 of the
                                # values kept per row
    shift_variant: str = ""
    expr_cols: tuple = ()       # computed: the Cols of the expression's variables;
                                # exponents: the bit Cols, LSB first
    constant: int = 0           # constant: the value; static_exp: the base;
                                # selected: the block index


class TableBuilder:
    def __init__(self, table_id: int, name: str = ""):
        self.table_id = table_id
        self.name = name
        self.columns: list[_ColumnDef] = []
        self.zero_constraints: list = []   # (name, log_vpr, expr, cols, steps)
        self.flushes: list = []            # (channel, direction, cols, multiplicity, selector)
        self.fixed_log_rows: int | None = None
        self.size_spec: str = "arbitrary"  # arbitrary | po2 | fixed
        self.nonzero_cols: list = []

    def assert_nonzero(self, col: Col) -> None:
        """The column must be non-zero in every row (proven by the
        grand-product phase)."""
        assert col.log_values_per_row == 0
        self.nonzero_cols.append(col)

    def require_power_of_two_size(self) -> None:
        self.size_spec = "po2"

    def require_fixed_size(self, log_rows: int) -> None:
        """Pin the table to exactly 2^log_rows rows (an indexed lookup
        table)."""
        self.fixed_log_rows = log_rows
        self.size_spec = "fixed"

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

    def add_computed(self, name: str, expr: ArithExpr, cols: list) -> Col:
        """A column defined as `expr` over var(i) = cols[i], all of one
        values-per-row (B128 in the oracle set; its witness is stored at the
        smallest level that holds it)."""
        vpr = cols[0].log_values_per_row
        assert all(c.log_values_per_row == vpr for c in cols)
        c = self._new_col(7, vpr, name)
        self.columns.append(_ColumnDef(c, "computed", inner=expr, expr_cols=tuple(cols)))
        return c

    def add_constant(self, name: str, level: int, value: int,
                     log_values_per_row: int = 0) -> Col:
        c = self._new_col(level, log_values_per_row, name)
        self.columns.append(_ColumnDef(c, "constant", constant=value))
        return c

    def add_fixed(self, name: str, level: int, pattern: list, log_values_per_row: int) -> Col:
        """A column that repeats the public per-row pattern of 2^v values."""
        assert len(pattern) == 1 << log_values_per_row
        c = self._new_col(level, log_values_per_row, name)
        self.columns.append(_ColumnDef(c, "fixed", inner=tuple(int(v) for v in pattern)))
        return c

    def add_structured(self, name: str, level: int, expr: ArithExpr) -> Col:
        """A column whose value at row r is `expr` on the bits of r (var i =
        bit i, LSB first); `expr` must be multilinear. Variables beyond the
        compiled table's log_rows are bound to zero."""
        c = self._new_col(level, 0, name)
        self.columns.append(_ColumnDef(c, "structured", inner=expr))
        return c

    def add_packed(self, name: str, inner: Col) -> Col:
        """One value per row at level inner.level + v: the row's 2^v values
        of `inner` joined, value 0 lowest."""
        assert inner.log_values_per_row > 0
        c = self._new_col(inner.level + inner.log_values_per_row, 0, name)
        self.columns.append(_ColumnDef(c, "packed", inner=inner))
        return c

    def add_selected(self, name: str, inner: Col, index: int) -> Col:
        """Value `index` of each row of `inner` (B128, one value per row)."""
        assert 0 <= index < (1 << inner.log_values_per_row)
        c = self._new_col(7, 0, name)
        self.columns.append(_ColumnDef(c, "selected", inner=inner, constant=index))
        return c

    def add_selected_block(self, name: str, inner: Col, index: int, log_new_vpr: int) -> Col:
        """The 2^log_new_vpr values of each row of `inner` from value index
        index << log_new_vpr on (B128)."""
        v = inner.log_values_per_row
        assert log_new_vpr < v and 0 <= index < (1 << (v - log_new_vpr))
        c = self._new_col(7, log_new_vpr, name)
        self.columns.append(_ColumnDef(c, "selected", inner=inner, constant=index,
                                       shift_block_bits=log_new_vpr))
        return c

    def add_static_exp(self, name: str, bit_cols: list, base: int, base_level: int) -> Col:
        """A committed column equal to base^(the exponent whose bits, LSB
        first, are the B1 `bit_cols`), proven by the GKR exponentiation
        phase. The prover computes its values; do not fill it."""
        vpr = bit_cols[0].log_values_per_row
        assert all(c.log_values_per_row == vpr and c.level == 0 for c in bit_cols)
        assert len(bit_cols) <= 1 << base_level
        c = self._new_col(base_level, vpr, name)
        self.columns.append(_ColumnDef(c, "static_exp", expr_cols=tuple(bit_cols),
                                       constant=base))
        return c

    def add_dynamic_exp(self, name: str, bit_cols: list, base: Col) -> Col:
        """A committed column equal to base^(bit-composed exponent), the
        base a column; the result has the base's level."""
        vpr = bit_cols[0].log_values_per_row
        assert all(c.log_values_per_row == vpr and c.level == 0 for c in bit_cols)
        assert base.log_values_per_row == vpr
        assert len(bit_cols) <= 1 << base.level
        c = self._new_col(base.level, vpr, name)
        self.columns.append(_ColumnDef(c, "dynamic_exp", inner=base, expr_cols=tuple(bit_cols)))
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

    def stat(self):
        """The table's proving-cost statistics (`m3.builder.stat.TableStat`)."""
        from .stat import TableStat
        return TableStat(self)

    def _check_flush(self, cols: list, selector) -> None:
        """A flush's columns share one values-per-row (every value of every
        row goes to the channel), and so does its selector."""
        vpr = cols[0].log_values_per_row
        assert all(c.log_values_per_row == vpr for c in cols), \
            "flush columns must share one values-per-row"
        assert selector is None or selector.log_values_per_row == vpr, \
            "flush selector must match the columns' values-per-row"

    def push(self, channel_id: int, cols: list, multiplicity: int = 1, selector=None) -> None:
        self._check_flush(cols, selector)
        self.flushes.append((channel_id, PUSH, tuple(cols), multiplicity, selector))

    def pull(self, channel_id: int, cols: list, multiplicity: int = 1, selector=None) -> None:
        self._check_flush(cols, selector)
        self.flushes.append((channel_id, PULL, tuple(cols), multiplicity, selector))


class M3ConstraintSystem:
    """Top-level builder: tables and channels."""

    def __init__(self):
        self.tables: list[TableBuilder] = []
        self.n_channels = 0

    def add_table(self, name: str = "") -> TableBuilder:
        t = TableBuilder(len(self.tables), name)
        self.tables.append(t)
        return t

    def add_channel(self) -> int:
        c = self.n_channels
        self.n_channels += 1
        return c

    def compile(self, table_log_rows: list[int]):
        """Lower with power-of-two row counts (`compile_sizes` of 2^each)."""
        return self.compile_sizes([1 << lr for lr in table_log_rows])

    def compile_sizes(self, table_sizes: list[int]):
        """Lower for the given table row counts. Returns (ConstraintSystem,
        oracle_map), oracle_map[(table_id, col_index)] = oracle id.

        Oracles take the power-of-two capacity of their table's size. Every
        flush of a table of arbitrary size spec gets that table's StepDown
        selector, even at a power-of-two size (the mask is then all ones),
        as the reference does; zero constraints hold over the whole
        capacity (the gadgets pad with rows that satisfy them)."""
        assert len(table_sizes) == len(self.tables)
        table_log_rows = []
        for t, size in zip(self.tables, table_sizes):
            assert size >= 0
            log_cap = max(0, (size - 1).bit_length())
            if t.size_spec == "fixed":
                assert size == 1 << t.fixed_log_rows, \
                    f"table {t.name} requires exactly 2^{t.fixed_log_rows} rows"
            elif t.size_spec == "po2":
                assert size == 1 << log_cap, f"table {t.name} requires a power-of-two size"
            assert size == 1 << log_cap or not t.nonzero_cols, \
                "non-zero claims need a power-of-two table (padding rows are 0)"
            table_log_rows.append(log_cap)
        oracles = om.OracleSet()
        oracle_map: dict = {}
        constraint_sets = []
        exponents = []
        non_zero_claims = []
        sym_oracles: list = []
        sym_csets: list = []
        sym_flushes: list = []
        sym_exps: list = []
        pending_flushes: list = []  # (table, channel, direction, ids, mult, sel ids, vpr, step-down)
        for t_idx, (t, log_rows) in enumerate(zip(self.tables, table_log_rows)):
            def rec(name, vpr, level, variant):
                sym_oracles.append(canon.SymbolicOracle(name, t_idx, vpr, level, variant))

            for cd in t.columns:
                col = cd.col
                vpr = col.log_values_per_row
                n_vars = log_rows + vpr
                key = (t.table_id, col.index)
                nm = f"{t.name}.{col.name}"
                if cd.kind == "committed":
                    oracle_map[key] = oracles.add_committed(n_vars, col.level, nm)
                    rec(nm, vpr, col.level, ("committed",))
                elif cd.kind == "shifted":
                    inner_id = oracle_map[(t.table_id, cd.inner.index)]
                    oracle_map[key] = oracles.add_shifted(
                        inner_id, cd.shift_offset, cd.shift_block_bits, cd.shift_variant, nm)
                    rec(nm, vpr, col.level, ("shifted", inner_id, cd.shift_offset,
                                             cd.shift_block_bits, cd.shift_variant))
                elif cd.kind == "computed":
                    expr = cd.inner
                    inner_ids = [oracle_map[(t.table_id, c.index)] for c in cd.expr_cols]
                    if expr.degree() > 1:
                        oracle_map[key] = oracles.add_composite(n_vars, inner_ids, expr, nm)
                        rec(nm, vpr, 7, ("composite", tuple(inner_ids),
                                         canon.circuit_steps(expr)))
                    else:
                        terms, offset = _linearize(expr, len(cd.expr_cols))
                        lc_terms = list(zip(inner_ids, terms))
                        oracle_map[key] = oracles.add_linear_combination(
                            n_vars, lc_terms, offset, nm)
                        rec(nm, vpr, 7, ("linear_combination", offset, tuple(lc_terms)))
                elif cd.kind == "constant":
                    # a one-row transparent `{name}_single` repeated over the
                    # rows as `{name}`, the column's oracle
                    tid = oracles.add_transparent(Constant(vpr, cd.constant, col.level),
                                                  nm + "_single")
                    rec(nm + "_single", vpr, col.level, (
                        "transparent", "Constant",
                        (("usize", vpr), ("f128", cd.constant), ("usize", col.level))))
                    oracle_map[key] = oracles.add_repeating(tid, log_rows, nm)
                    rec(nm, vpr, col.level, ("repeating", tid))
                elif cd.kind == "fixed":
                    tid = oracles.add_transparent(MLEFromValues(cd.inner, col.level),
                                                  nm + ".pattern")
                    rec(nm + ".pattern", vpr, col.level, (
                        "transparent", "MultilinearExtensionTransparent",
                        (("vec_f128", cd.inner),)))
                    oracle_map[key] = oracles.add_repeating(tid, log_rows, nm)
                    rec(nm, vpr, col.level, ("repeating", tid))
                elif cd.kind == "structured":
                    tp = StructuredArith(_bind_high_vars_zero(cd.inner, n_vars), n_vars,
                                         col.level)
                    oracle_map[key] = oracles.add_transparent(tp, nm)
                    # sizeless: the circuit before binding
                    rec(nm, vpr, col.level, ("structured", canon.circuit_steps(cd.inner)))
                elif cd.kind in ("static_exp", "dynamic_exp"):
                    # the oracle in declaration order; its Exp record comes
                    # with its partition below
                    oracle_map[key] = oracles.add_committed(n_vars, col.level, nm)
                    rec(nm, vpr, col.level, ("committed",))
                elif cd.kind == "packed":
                    inner_id = oracle_map[(t.table_id, cd.inner.index)]
                    log_degree = cd.inner.log_values_per_row
                    oracle_map[key] = oracles.add_packed(inner_id, log_degree, nm)
                    rec(nm, vpr, col.level, ("packed", inner_id, log_degree))
                elif cd.kind == "selected":
                    inner_id = oracle_map[(t.table_id, cd.inner.index)]
                    nb = cd.inner.log_values_per_row - cd.shift_block_bits
                    bits = tuple((cd.constant >> i) & 1 for i in range(nb))
                    oracle_map[key] = oracles.add_projected(inner_id, bits, cd.shift_block_bits,
                                                            nm)
                    rec(nm, vpr, 7, ("projected", inner_id, bits,
                                     ("offset", cd.shift_block_bits)))
                else:
                    raise ValueError(f"unknown column kind {cd.kind!r}")

            # per partition, ascending values-per-row: the Exp records of its
            # exponent columns in declaration order, its flushes in call
            # order, then one constraint set of the used columns in
            # declaration order, the constraints in call order
            for vpr in sorted({c.col.log_values_per_row for c in t.columns}):
                for cd in t.columns:
                    if (cd.col.log_values_per_row != vpr
                            or cd.kind not in ("static_exp", "dynamic_exp")):
                        continue
                    res_id = oracle_map[(t.table_id, cd.col.index)]
                    bits_ids = tuple(oracle_map[(t.table_id, b.index)] for b in cd.expr_cols)
                    if cd.kind == "static_exp":
                        exponents.append(Exp(bits_ids, res_id, cd.col.level,
                                             base_const=cd.constant))
                        base = ("const", cd.constant, cd.col.level)
                    else:
                        base_id = oracle_map[(t.table_id, cd.inner.index)]
                        exponents.append(Exp(bits_ids, res_id, cd.col.level, base_oracle=base_id))
                        base = ("oracle", base_id)
                    sym_exps.append(canon.SymbolicExp(bits_ids, base, res_id))
                for channel_id, direction, cols, mult, selector in t.flushes:
                    if cols[0].log_values_per_row != vpr:
                        continue
                    sel_ids = ((oracle_map[(t.table_id, selector.index)],)
                               if selector is not None else ())
                    ids = tuple(oracle_map[(t.table_id, c.index)] for c in cols)
                    pending_flushes.append((t_idx, channel_id, direction, ids, mult, sel_ids,
                                            vpr, t.size_spec not in ("fixed", "po2")))
                    sym_flushes.append(canon.SymbolicFlush(
                        t_idx, vpr, tuple(("oracle", i) for i in ids), channel_id, direction,
                        sel_ids, mult))
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
            # non-zero claims in column declaration order
            for c in sorted(t.nonzero_cols, key=lambda c: c.index):
                non_zero_claims.append(NonZeroClaim(oracle_map[(t.table_id, c.index)]))

        # the step-down selectors, one per (table, values-per-row), after
        # every symbolic oracle: the sizeless description stays a prefix of
        # the oracle set. A multi-value flush's rows are runs of 2^vpr
        # values, so StepDown(log_rows + vpr, size << vpr) covers `size` rows.
        step_down_ids: dict = {}
        flushes = []
        for t_idx, channel_id, direction, ids, mult, sel_ids, vpr, needs_sd in pending_flushes:
            if needs_sd:
                if (t_idx, vpr) not in step_down_ids:
                    t = self.tables[t_idx]
                    step_down_ids[(t_idx, vpr)] = oracles.add_transparent(
                        StepDown(table_log_rows[t_idx] + vpr, table_sizes[t_idx] << vpr),
                        f"{t.name}.stepdown{vpr}")
                sel_ids = sel_ids + (step_down_ids[(t_idx, vpr)],)
            flushes.append(Flush(channel_id, direction, ids, mult, sel_ids))

        specs = tuple(("fixed", t.fixed_log_rows) if t.size_spec == "fixed" else (t.size_spec,)
                      for t in self.tables)
        symbolic = canon.SymbolicSystem(
            tuple(sym_oracles), tuple(sym_csets), tuple(nz.oracle_id for nz in non_zero_claims),
            tuple(sym_flushes), tuple(sym_exps), self.n_channels, specs)
        return ConstraintSystem(oracles, constraint_sets, flushes, self.n_channels,
                                non_zero_claims, exponents, symbolic=symbolic), oracle_map


def _bind_high_vars_zero(expr: ArithExpr, n_vars: int) -> ArithExpr:
    """`expr` with var(i >= n_vars) replaced by the constant 0 (a structured
    column is defined for a largest size; a smaller table has no such
    index bits)."""
    if expr.op == "var":
        return ArithExpr.const(0) if expr.value >= n_vars else expr
    if expr.op == "const":
        return expr
    args = tuple(_bind_high_vars_zero(a, n_vars) for a in expr.args)
    if expr.op == "add":
        return args[0] + args[1]
    if expr.op == "mul":
        return args[0] * args[1]
    return ArithExpr("pow", args, expr.value)


def _linearize(expr: ArithExpr, n_vars: int):
    """(coefficient per variable, constant offset) of a degree <= 1
    expression, by evaluation at the unit vectors (characteristic 2)."""
    offset = expr.evaluate_scalar(7, [0] * n_vars)
    coeffs = []
    for i in range(n_vars):
        pt = [0] * n_vars
        pt[i] = 1
        coeffs.append(expr.evaluate_scalar(7, pt) ^ offset)
    return coeffs, offset
