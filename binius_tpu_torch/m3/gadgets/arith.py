"""The u32 arithmetic and bitwise gadgets.

The port of `U32Add`, `U32Sub` and `u32_bitwise_and` / `_xor` / `_or` of
`binius_tpu/m3/gadgets/arith.py` (over vertically packed B1 columns, one
u32 per row), with the host witness values of the adder's and the
subtracter's committed columns (`u32_add_populate`, `u32_sub_populate`)
and the seeded instances that `chip_smoke.py` and the tests prove: the
u32_add and u32_sub tables and `examples/bitwise_ops.py`'s table of the
three bitwise ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...math.arith import ArithExpr
from ...protocols import shift_ind
from ...utils import tracing
from ..builder.table import Col, M3ConstraintSystem, TableBuilder
from ..builder.witness import WitnessIndex

V = ArithExpr.var
LOG_U32 = 5


def u32_add_populate(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(zout, cout) words for rows x + y: carry-in word = (x+y) ^ x ^ y,
    carry-out = carry-in >> 1 with the bit-32 overflow at position 31."""
    x = x.astype(np.uint64)
    y = y.astype(np.uint64)
    full = x + y
    cin = full ^ x ^ y
    cout = ((cin >> np.uint64(1)) & np.uint64(0x7FFFFFFF)) | ((full >> np.uint64(32)) << np.uint64(31))
    return (full & np.uint64(0xFFFFFFFF)).astype(np.uint32), cout.astype(np.uint32)


def u32_sub_populate(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(zout, bout) words for rows x - y: borrow-in word = x ^ y ^ (x-y),
    borrow-out = borrow-in >> 1 with the overall borrow (x < y) at
    position 31."""
    x = x.astype(np.uint64)
    y = y.astype(np.uint64)
    z = (x - y) & np.uint64(0xFFFFFFFF)
    bout = (((x ^ y ^ z) >> np.uint64(1)) & np.uint64(0x7FFFFFFF)) \
        | ((x < y).astype(np.uint64) << np.uint64(31))
    return z.astype(np.uint32), bout.astype(np.uint32)


@dataclasses.dataclass
class U32Add:
    """zout = xin + yin (mod 2^32), through carry columns. Constraints over
    the B1 bit columns (32 values per row):
      cin = cout << 1 within the row (the carry into bit i is out of i-1)
      (xin + cin)(yin + cin) + cin + cout = 0      [carry generation]
      xin + yin + cin + zout = 0                   [sum]
    """

    xin: Col
    yin: Col
    zout: Col
    cout: Col
    cin: Col

    @staticmethod
    def build(t: TableBuilder, name: str, xin: Col, yin: Col) -> "U32Add":
        zout = t.add_committed(f"{name}.zout", 0, LOG_U32)
        cout = t.add_committed(f"{name}.cout", 0, LOG_U32)
        cin = t.add_shifted(f"{name}.cin", cout, 1, LOG_U32, shift_ind.LOGICAL_LEFT)
        x, y, ci, z, co = (V(i) for i in range(5))
        t.assert_zero(f"{name}.carry", [xin, yin, cin, zout, cout],
                      (x + ci) * (y + ci) + ci + co, group=name)
        t.assert_zero(f"{name}.sum", [xin, yin, cin, zout, cout], x + y + ci + z, group=name)
        return U32Add(xin, yin, zout, cout, cin)

    def populate(self, tw, x_rows, y_rows) -> np.ndarray:
        """Fill zout and cout from per-row u32 inputs; returns the sums."""
        z, cout = u32_add_populate(np.asarray(x_rows, dtype=np.uint64),
                                   np.asarray(y_rows, dtype=np.uint64))
        tw.set_packed_ints(self.zout, z)
        tw.set_packed_ints(self.cout, cout)
        return z


@dataclasses.dataclass
class U32Sub:
    """zout = xin - yin (mod 2^32), through borrow columns:
      bin = bout << 1 within the row
      (1 + xin + bin)(yin + bin) + bin + bout = 0   [borrow]
      xin + yin + bin + zout = 0                    [difference]
    """

    xin: Col
    yin: Col
    zout: Col
    bout: Col
    bin_: Col

    @staticmethod
    def build(t: TableBuilder, name: str, xin: Col, yin: Col) -> "U32Sub":
        zout = t.add_committed(f"{name}.zout", 0, LOG_U32)
        bout = t.add_committed(f"{name}.bout", 0, LOG_U32)
        bin_ = t.add_shifted(f"{name}.bin", bout, 1, LOG_U32, shift_ind.LOGICAL_LEFT)
        x, y, bi, z, bo = (V(i) for i in range(5))
        t.assert_zero(f"{name}.borrow", [xin, yin, bin_, zout, bout],
                      (x + bi + ArithExpr.const(1)) * (y + bi) + bi + bo)
        t.assert_zero(f"{name}.diff", [xin, yin, bin_, zout, bout], x + y + bi + z)
        return U32Sub(xin, yin, zout, bout, bin_)

    def populate(self, tw, x_rows, y_rows) -> np.ndarray:
        """Fill zout and bout from per-row u32 inputs; returns the
        differences."""
        z, bout = u32_sub_populate(np.asarray(x_rows, dtype=np.uint64),
                                   np.asarray(y_rows, dtype=np.uint64))
        tw.set_packed_ints(self.zout, z)
        tw.set_packed_ints(self.bout, bout)
        return z


def u32_bitwise_and(t: TableBuilder, name: str, xin: Col, yin: Col) -> Col:
    zout = t.add_committed(f"{name}.zout", 0, LOG_U32)
    x, y, z = V(0), V(1), V(2)
    t.assert_zero(f"{name}.and", [xin, yin, zout], x * y + z)
    return zout


def u32_bitwise_xor(t: TableBuilder, name: str, xin: Col, yin: Col) -> Col:
    zout = t.add_committed(f"{name}.zout", 0, LOG_U32)
    x, y, z = V(0), V(1), V(2)
    t.assert_zero(f"{name}.xor", [xin, yin, zout], x + y + z)
    return zout


def u32_bitwise_or(t: TableBuilder, name: str, xin: Col, yin: Col) -> Col:
    zout = t.add_committed(f"{name}.zout", 0, LOG_U32)
    x, y, z = V(0), V(1), V(2)
    t.assert_zero(f"{name}.or", [xin, yin, zout], x + y + x * y + z)
    return zout


def bitwise_system(log_rows: int, xs, ys, device=None):
    """`examples/bitwise_ops.py`'s table "bitwise" of 2^log_rows rows: the
    u32 inputs xin and yin and their AND, XOR and OR, and its witness on
    `device` (CUDA unless named): returns (core system, witness)."""
    with tracing.span("frontend/compile", root=True):
        m3 = M3ConstraintSystem()
        t = m3.add_table("bitwise")
        xin = t.add_committed("xin", 0, LOG_U32)
        yin = t.add_committed("yin", 0, LOG_U32)
        outs = [u32_bitwise_and(t, "and", xin, yin), u32_bitwise_xor(t, "xor", xin, yin),
                u32_bitwise_or(t, "or", xin, yin)]
        core, omap = m3.compile([log_rows])
    with tracing.span("frontend/witness", root=True):
        wi = WitnessIndex(m3, [log_rows])
        tw = wi.table(0)
        xs, ys = np.asarray(xs, dtype=np.uint64), np.asarray(ys, dtype=np.uint64)
        for col, vals in zip((xin, yin, *outs), (xs, ys, xs & ys, xs ^ ys, xs | ys)):
            tw.set_packed_ints(col, vals)
    return core, wi.to_core_witness(core, omap, device)


def u32_add_system(log_rows: int, xs, ys, device=None):
    """The one-table u32_add system of 2^log_rows rows adding the u32 rows
    xs and ys, and its witness on `device` (CUDA unless named): returns
    (core system, witness)."""
    with tracing.span("frontend/compile", root=True):
        m3 = M3ConstraintSystem()
        t = m3.add_table("u32add")
        xin = t.add_committed("xin", 0, LOG_U32)
        yin = t.add_committed("yin", 0, LOG_U32)
        adder = U32Add.build(t, "add", xin, yin)
        core, omap = m3.compile([log_rows])
    with tracing.span("frontend/witness", root=True):
        wi = WitnessIndex(m3, [log_rows])
        tw = wi.table(0)
        tw.set_packed_ints(xin, xs)
        tw.set_packed_ints(yin, ys)
        adder.populate(tw, xs, ys)
    return core, wi.to_core_witness(core, omap, device)


def u32_sub_system(log_rows: int, xs, ys, device=None):
    """The one-table ("u32sub") system of 2^log_rows rows subtracting the
    u32 rows ys from xs, and its witness on `device` (CUDA unless named):
    returns (core system, witness)."""
    with tracing.span("frontend/compile", root=True):
        m3 = M3ConstraintSystem()
        t = m3.add_table("u32sub")
        xin = t.add_committed("xin", 0, LOG_U32)
        yin = t.add_committed("yin", 0, LOG_U32)
        sub = U32Sub.build(t, "sub", xin, yin)
        core, omap = m3.compile([log_rows])
    with tracing.span("frontend/witness", root=True):
        wi = WitnessIndex(m3, [log_rows])
        tw = wi.table(0)
        tw.set_packed_ints(xin, xs)
        tw.set_packed_ints(yin, ys)
        sub.populate(tw, xs, ys)
    return core, wi.to_core_witness(core, omap, device)


def u32_add_rows(log_rows: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """2^log_rows random u32 pairs drawn from numpy's `default_rng(seed)`,
    x then y (the u32_add, u32_sub, u32_mul and bitwise_ops instances)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, 1 << log_rows, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, 1 << log_rows, dtype=np.uint64)
    return x, y


def u32_add_instance(log_rows: int, seed: int) -> tuple[list[np.ndarray], list[int]]:
    """The committed columns [xin, yin, zout, cout] of a 2^log_rows-row
    table with random inputs drawn from `seed`, as uint32 P1 words, and an
    evaluation point for them: log_rows + 5 B128 coordinates drawn from the
    same generator after the witness (16 bytes each, little-endian), a
    stand-in for the point a zerocheck leaves its column claims at (the
    opening's instance)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, 1 << log_rows, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, 1 << log_rows, dtype=np.uint64)
    z, cout = u32_add_populate(x, y)
    point = [int.from_bytes(rng.bytes(16), "little") for _ in range(log_rows + 5)]
    return [x.astype(np.uint32), y.astype(np.uint32), z, cout], point


def u32_add_columns(log_rows: int, seed: int) -> list[np.ndarray]:
    """The committed columns of `u32_add_instance`."""
    return u32_add_instance(log_rows, seed)[0]
