"""The u32 multiplication gadgets.

The port of `binius_tpu/m3/gadgets/mul.py`: `U32Mul` (the low 32 bits of
a product, schoolbook: 32 partial products summed by 31 `U32Add`s) and
`MulUU32` (full 64-bit products through the GKR exponentiation phase),
with the seeded instances of the u32_mul table and of
`examples/u32_mul_gkr.py` that `chip_smoke.py` and the tests prove.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

from ...fields import scalar
from ...math.arith import ArithExpr
from ...protocols import shift_ind
from ..builder.table import Col, M3ConstraintSystem, TableBuilder
from ..builder.witness import WitnessIndex
from .arith import LOG_U32, U32Add

V = ArithExpr.var
M32 = 0xFFFFFFFF


@dataclasses.dataclass
class U32Mul:
    """zout = xin * yin (mod 2^32), schoolbook:
      * the multiplier's bits b_i are committed, each the same in all 32
        values of a row (equal to its rotation by one) and tied to yin by a
        one-hot fixed column: (b_i + yin) * onehot_i = 0;
      * the partial product p_i = (xin << i) & b_i is committed, with
        p_i + xshift_i * b_i = 0;
      * the 32 partial products are summed by 31 `U32Add`s."""

    xin: Col
    yin: Col
    zout: Col
    bit_cols: list
    partial_cols: list
    adders: list

    @staticmethod
    def build(t: TableBuilder, name: str, xin: Col, yin: Col) -> "U32Mul":
        bit_cols, partial_cols, adders = [], [], []
        for i in range(32):
            b = t.add_committed(f"{name}.b{i}", 0, LOG_U32)
            bit_cols.append(b)
            onehot = t.add_fixed(f"{name}.oh{i}", 0, [1 if z == i else 0 for z in range(32)],
                                 LOG_U32)
            t.assert_zero(f"{name}.b{i}.tie", [b, yin, onehot], (V(0) + V(1)) * V(2),
                          group=f"{name}.bit{i}")
            b_rot = t.add_shifted(f"{name}.b{i}.rot", b, 1, LOG_U32, shift_ind.CIRCULAR_LEFT)
            t.assert_zero(f"{name}.b{i}.const", [b, b_rot], V(0) + V(1), group=f"{name}.bit{i}")
            xs = xin if i == 0 else t.add_shifted(f"{name}.xs{i}", xin, i, LOG_U32,
                                                  shift_ind.LOGICAL_LEFT)
            p = t.add_committed(f"{name}.p{i}", 0, LOG_U32)
            t.assert_zero(f"{name}.p{i}.def", [p, xs, b], V(0) + V(1) * V(2),
                          group=f"{name}.bit{i}")
            partial_cols.append(p)
        acc = partial_cols[0]
        for i in range(1, 32):
            adder = U32Add.build(t, f"{name}.acc{i}", acc, partial_cols[i])
            adders.append(adder)
            acc = adder.zout
        return U32Mul(xin, yin, acc, bit_cols, partial_cols, adders)

    def populate(self, tw, x_rows, y_rows) -> np.ndarray:
        """Fill the bit, partial-product and adder columns from the u32
        rows; returns the low words of the products."""
        x = np.asarray(x_rows, dtype=np.uint64)
        y = np.asarray(y_rows, dtype=np.uint64)
        partials = []
        for i, (b_col, p_col) in enumerate(zip(self.bit_cols, self.partial_cols)):
            bit = (y >> np.uint64(i)) & np.uint64(1)
            tw.set_packed_ints(b_col, bit * np.uint64(M32))
            partials.append(((x << np.uint64(i)) & np.uint64(M32)) * bit)
            tw.set_packed_ints(p_col, partials[-1])
        acc = partials[0]
        for adder, partial in zip(self.adders, partials[1:]):
            acc = adder.populate(tw, acc, partial)
        return acc


def _pack_bits_expr(n: int) -> ArithExpr:
    """sum_i var(i) * 2^i: packs n B1 basis bits into one tower element."""
    e = None
    for i in range(n):
        term = V(i) * ArithExpr.const(1 << i, 7)
        e = term if e is None else e + term
    return e


@dataclasses.dataclass
class MulUU32:
    """x * y = out_high * 2^32 + out_low for u32 x and y. With g a
    generator of B64 (of order 2^64 - 1),

        (g^x)^y = g^out_low * (g^(2^32))^out_high

    forces the product up to one wrap by 2^64 - 1, which the parity
    constraint x_0 * y_0 = out_low_0 excludes (2^64 - 1 is odd).

    Columns: 32 B1 columns of one bit per row for each operand and each
    half of the product (the exponentiation circuits read single bit
    oracles), and four B64 exponent columns that the prover fills."""

    x_bits: list
    y_bits: list
    out_low_bits: list
    out_high_bits: list
    g_pow_x: Col
    g_pow_xy: Col
    g_pow_out_low: Col
    g_pow_out_high: Col
    xin: Col
    yin: Col
    out_low: Col
    out_high: Col

    @staticmethod
    def build(t: TableBuilder, name: str = "mul", x_bits: list = None,
              y_bits: list = None) -> "MulUU32":
        """The operands' bit columns are committed here unless the caller
        passes its own (32 B1 columns of one bit per row each, LSB first)."""
        if x_bits is None:
            x_bits = [t.add_committed(f"{name}.x{i}", 0, 0) for i in range(32)]
        if y_bits is None:
            y_bits = [t.add_committed(f"{name}.y{i}", 0, 0) for i in range(32)]
        g = scalar.GENERATORS[6]
        g_shift = scalar.pow(6, g, 1 << 32)

        g_pow_x = t.add_static_exp(f"{name}.g^x", x_bits, g, 6)
        g_pow_xy = t.add_dynamic_exp(f"{name}.(g^x)^y", y_bits, g_pow_x)

        out_low_bits = [t.add_committed(f"{name}.lo{i}", 0, 0) for i in range(32)]
        out_high_bits = [t.add_committed(f"{name}.hi{i}", 0, 0) for i in range(32)]

        g_pow_out_low = t.add_static_exp(f"{name}.g^lo", out_low_bits, g, 6)
        g_pow_out_high = t.add_static_exp(f"{name}.(g^2^32)^hi", out_high_bits, g_shift, 6)

        t.assert_zero(f"{name}.order_non_wrapping", [x_bits[0], y_bits[0], out_low_bits[0]],
                      V(0) * V(1) + V(2), group=f"{name}.parity")
        t.assert_zero(f"{name}.exponentiation_equality",
                      [g_pow_xy, g_pow_out_low, g_pow_out_high],
                      V(0) + V(1) * V(2), group=f"{name}.expeq")

        xin = t.add_computed(f"{name}.xin", _pack_bits_expr(32), x_bits)
        yin = t.add_computed(f"{name}.yin", _pack_bits_expr(32), y_bits)
        out_low = t.add_computed(f"{name}.out_low", _pack_bits_expr(32), out_low_bits)
        out_high = t.add_computed(f"{name}.out_high", _pack_bits_expr(32), out_high_bits)
        return MulUU32(x_bits, y_bits, out_low_bits, out_high_bits,
                       g_pow_x, g_pow_xy, g_pow_out_low, g_pow_out_high,
                       xin, yin, out_low, out_high)

    def populate(self, tw, x_rows, y_rows) -> tuple[np.ndarray, np.ndarray]:
        """Fill the bit columns from the u32 rows; returns (out_high,
        out_low). The prover computes the exponent columns."""
        x = np.asarray(x_rows, dtype=np.uint64)
        y = np.asarray(y_rows, dtype=np.uint64)
        p = x * y   # exact: 32 x 32 -> 64 bits
        lo, hi = p & np.uint64(M32), p >> np.uint64(32)
        for cols, v in ((self.x_bits, x), (self.y_bits, y),
                        (self.out_low_bits, lo), (self.out_high_bits, hi)):
            for i, col in enumerate(cols):
                tw.set_column(col, ((v >> np.uint64(i)) & np.uint64(1)).astype(np.uint32))
        return hi, lo


def mul_inputs(log_n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """2^log_n random u32 pairs as `examples/u32_mul_gkr.py` draws them
    after `random.seed(seed)`: x and then y, each `getrandbits(32)` (here
    from a `random.Random(seed)` of the same sequence, leaving the global
    generator alone)."""
    rng = random.Random(seed)
    xs = [rng.getrandbits(32) for _ in range(1 << log_n)]
    ys = [rng.getrandbits(32) for _ in range(1 << log_n)]
    return np.array(xs, dtype=np.uint64), np.array(ys, dtype=np.uint64)


def mul_table(log_n: int):
    """The one-table ("mul") system of 2^log_n u32 products: (M3 system,
    gadget, core system, oracle map)."""
    m3 = M3ConstraintSystem()
    gadget = MulUU32.build(m3.add_table("mul"), "mul")
    core, omap = m3.compile([log_n])
    return m3, gadget, core, omap


def mul_system(log_n: int, xs, ys, device=None):
    """The system of `mul_table` for the products x * y and its witness
    on `device` (CUDA unless named), the exponent columns computed there:
    returns (core system, witness)."""
    m3, gadget, core, omap = mul_table(log_n)
    wi = WitnessIndex(m3, [log_n])
    gadget.populate(wi.table(0), xs, ys)
    return core, wi.to_core_witness(core, omap, device)


def u32_mul_system(log_rows: int, xs, ys, device=None):
    """The one-table ("mul") system of 2^log_rows schoolbook products
    (`U32Mul` of the committed xin and yin) of the u32 rows xs and ys, and
    its witness on `device` (CUDA unless named): returns (core system,
    witness)."""
    m3 = M3ConstraintSystem()
    t = m3.add_table("mul")
    xin = t.add_committed("xin", 0, LOG_U32)
    yin = t.add_committed("yin", 0, LOG_U32)
    gadget = U32Mul.build(t, "mul", xin, yin)
    core, omap = m3.compile([log_rows])
    wi = WitnessIndex(m3, [log_rows])
    tw = wi.table(0)
    tw.set_packed_ints(xin, xs)
    tw.set_packed_ints(yin, ys)
    gadget.populate(tw, xs, ys)
    return core, wi.to_core_witness(core, omap, device)
