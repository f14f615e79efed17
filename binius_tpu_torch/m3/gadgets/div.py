"""Unsigned u32 division: p = q * div + rem with rem < q and q != 0.

The port of `binius_tpu/m3/gadgets/div.py`: the 64-bit product comes from
the exponentiation-based `MulUU32`, the identity is checked by a 64-bit
ripple adder (`WideAdd`) over bit columns, rem < q by a 64-bit
subtraction (`WideSub`) whose sign bit must be set, and q != 0 is a
non-zero claim (the grand-product phase). These gadgets work on B1
columns of one bit per row (the exponentiation circuits read single-bit
oracles), so a carry chain links adjacent columns: the carry into bit i
is the carry out of bit i - 1.

Their witnesses (`populate`) are computed on numpy words for all rows at
once, with the JAX module's values; the seeded instance that
`chip_smoke.py` and the tests prove is one table of divisions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...math.arith import ArithExpr
from ...utils import tracing
from ..builder.table import Col, M3ConstraintSystem, TableBuilder
from ..builder.witness import WitnessIndex
from .mul import MulUU32

V = ArithExpr.var
_ONE = np.uint64(1)


def _set_bits(tw, cols: list, values: np.ndarray) -> None:
    """Column i of `cols` gets bit i of each row's value."""
    for i, col in enumerate(cols):
        tw.set_column(col, ((values >> np.uint64(i)) & _ONE).astype(np.uint32))


def _chain_out(chain_in: np.ndarray, top: np.ndarray, n: int) -> np.ndarray:
    """The carries (or borrows) out of bits 0..n-1 of an n-bit ripple
    chain, from the word of the carries into bits 0..63 and the carry out
    of bit 63: out of bit i is into bit i + 1."""
    out = (chain_in >> _ONE) | (top.astype(np.uint64) << np.uint64(63))
    return out if n == 64 else out & np.uint64((1 << n) - 1)


@dataclasses.dataclass
class WideAdd:
    """z = x + y over n bit columns, with committed sum and carry-out bits.
    Per bit i, with cin_0 = 0 and cin_i = cout_{i-1}:
        cout_i + x_i * y_i + cin_i * (x_i + y_i) = 0
        z_i + x_i + y_i + cin_i = 0
    """

    x_bits: list
    y_bits: list
    z_bits: list
    cout_bits: list

    @staticmethod
    def build(t: TableBuilder, name: str, x_bits: list, y_bits: list) -> "WideAdd":
        n = len(x_bits)
        assert len(y_bits) == n
        z_bits = [t.add_committed(f"{name}.z{i}", 0, 0) for i in range(n)]
        cout = [t.add_committed(f"{name}.c{i}", 0, 0) for i in range(n)]
        for i in range(n):
            if i == 0:
                t.assert_zero(f"{name}.carry0", [x_bits[0], y_bits[0], cout[0]],
                              V(0) * V(1) + V(2), group=f"{name}.bit")
                t.assert_zero(f"{name}.sum0", [x_bits[0], y_bits[0], z_bits[0]],
                              V(0) + V(1) + V(2), group=f"{name}.bit")
            else:
                cin = cout[i - 1]
                t.assert_zero(f"{name}.carry{i}", [x_bits[i], y_bits[i], cin, cout[i]],
                              V(0) * V(1) + V(2) * (V(0) + V(1)) + V(3), group=f"{name}.bitc")
                t.assert_zero(f"{name}.sum{i}", [x_bits[i], y_bits[i], cin, z_bits[i]],
                              V(0) + V(1) + V(2) + V(3), group=f"{name}.bitc")
        return WideAdd(x_bits, y_bits, z_bits, cout)

    def populate(self, tw, x_rows, y_rows) -> np.ndarray:
        """x_rows, y_rows: n-bit values per row; fills the sum and carry
        bits and returns the sums mod 2^n."""
        n = len(self.x_bits)
        x = np.asarray(x_rows, dtype=np.uint64)
        y = np.asarray(y_rows, dtype=np.uint64)
        full = x + y   # mod 2^64
        z = full if n == 64 else full & np.uint64((1 << n) - 1)
        _set_bits(tw, self.z_bits, z)
        _set_bits(tw, self.cout_bits, _chain_out(full ^ x ^ y, full < x, n))
        return z


@dataclasses.dataclass
class WideSub:
    """z = x - y over n bit columns, with committed difference and
    borrow-out bits (the borrow chain of `WideAdd`)."""

    x_bits: list
    y_bits: list
    z_bits: list
    bout_bits: list

    @staticmethod
    def build(t: TableBuilder, name: str, x_bits: list, y_bits: list) -> "WideSub":
        n = len(x_bits)
        assert len(y_bits) == n
        z_bits = [t.add_committed(f"{name}.z{i}", 0, 0) for i in range(n)]
        bout = [t.add_committed(f"{name}.b{i}", 0, 0) for i in range(n)]
        one = ArithExpr.const(1)
        for i in range(n):
            if i == 0:
                # borrow0 = (1 + x) * y; z0 = x + y
                t.assert_zero(f"{name}.borrow0", [x_bits[0], y_bits[0], bout[0]],
                              (V(0) + one) * V(1) + V(2), group=f"{name}.bit")
                t.assert_zero(f"{name}.diff0", [x_bits[0], y_bits[0], z_bits[0]],
                              V(0) + V(1) + V(2), group=f"{name}.bit")
            else:
                bin_ = bout[i - 1]
                # borrow = (1 + x + bin)(y + bin) + bin; z = x + y + bin
                t.assert_zero(f"{name}.borrow{i}", [x_bits[i], y_bits[i], bin_, bout[i]],
                              (V(0) + V(2) + one) * (V(1) + V(2)) + V(2) + V(3),
                              group=f"{name}.bitb")
                t.assert_zero(f"{name}.diff{i}", [x_bits[i], y_bits[i], bin_, z_bits[i]],
                              V(0) + V(1) + V(2) + V(3), group=f"{name}.bitb")
        return WideSub(x_bits, y_bits, z_bits, bout)

    def populate(self, tw, x_rows, y_rows) -> np.ndarray:
        """x_rows, y_rows: n-bit values per row; fills the difference and
        borrow bits and returns the differences mod 2^n."""
        n = len(self.x_bits)
        x = np.asarray(x_rows, dtype=np.uint64)
        y = np.asarray(y_rows, dtype=np.uint64)
        full = x - y   # mod 2^64
        z = full if n == 64 else full & np.uint64((1 << n) - 1)
        _set_bits(tw, self.z_bits, z)
        _set_bits(tw, self.bout_bits, _chain_out(full ^ x ^ y, x < y, n))
        return z


@dataclasses.dataclass
class DivUU32:
    """p = q * div + rem, rem < q, q != 0, over 32 bit columns each."""

    p_bits: list
    q_bits: list
    div_bits: list
    rem_bits: list
    mul: MulUU32
    sum: WideAdd
    cmp: WideSub
    q_in: Col

    @staticmethod
    def build(t: TableBuilder, name: str = "div") -> "DivUU32":
        zero = t.add_constant(f"{name}.zero", 0, 0)
        p_bits = [t.add_committed(f"{name}.p{i}", 0, 0) for i in range(32)]
        q_bits = [t.add_committed(f"{name}.q{i}", 0, 0) for i in range(32)]
        div_bits = [t.add_committed(f"{name}.d{i}", 0, 0) for i in range(32)]
        rem_bits = [t.add_committed(f"{name}.r{i}", 0, 0) for i in range(32)]

        mul = MulUU32.build(t, f"{name}.mul", x_bits=q_bits, y_bits=div_bits)
        t.assert_nonzero(mul.xin)  # q != 0

        product64 = mul.out_low_bits + mul.out_high_bits
        rem64 = rem_bits + [zero] * 32
        q64 = q_bits + [zero] * 32

        # p = q * div + rem in 64 bits
        s = WideAdd.build(t, f"{name}.sum", product64, rem64)
        for i in range(64):
            want = p_bits[i] if i < 32 else zero
            t.assert_zero(f"{name}.division_satisfied[{i}]", [s.z_bits[i], want], V(0) + V(1),
                          group=f"{name}.divsat")

        # rem < q: rem - q in 64 bits has its sign bit set
        cmp = WideSub.build(t, f"{name}.cmp", rem64, q64)
        t.assert_zero(f"{name}.less_than", [cmp.z_bits[63]], V(0) + ArithExpr.const(1),
                      group=f"{name}.lt")
        return DivUU32(p_bits, q_bits, div_bits, rem_bits, mul, s, cmp, mul.xin)

    def populate(self, tw, p_rows, q_rows) -> tuple[np.ndarray, np.ndarray]:
        """Fill every committed column from the u32 rows p and q (q non-zero
        in every row); returns (div, rem)."""
        p = np.asarray(p_rows, dtype=np.uint64)
        q = np.asarray(q_rows, dtype=np.uint64)
        div, rem = p // q, p % q
        _set_bits(tw, self.p_bits, p)
        _set_bits(tw, self.q_bits, q)
        _set_bits(tw, self.rem_bits, rem)
        self.mul.populate(tw, q, div)
        self.sum.populate(tw, q * div, rem)
        self.cmp.populate(tw, rem, q)
        return div, rem


def div_inputs(log_rows: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """From numpy's `default_rng(seed)`: 2^log_rows u32 dividends p, then
    2^log_rows divisors q, each 16 random bits plus one."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 1 << 32, 1 << log_rows, dtype=np.uint64)
    q = rng.integers(0, 1 << 16, 1 << log_rows, dtype=np.uint64) + np.uint64(1)
    return p, q


def div_system(log_rows: int, ps, qs, device=None):
    """The one-table ("div") system of 2^log_rows divisions of the u32 rows
    ps by qs (`DivUU32`), and its witness on `device` (CUDA unless named),
    the exponent columns computed there: returns (core system, witness)."""
    with tracing.span("frontend/compile", root=True):
        m3 = M3ConstraintSystem()
        gadget = DivUU32.build(m3.add_table("div"), "div")
        core, omap = m3.compile([log_rows])
    with tracing.span("frontend/witness", root=True):
        wi = WitnessIndex(m3, [log_rows])
        gadget.populate(wi.table(0), ps, qs)
    return core, wi.to_core_witness(core, omap, device)
