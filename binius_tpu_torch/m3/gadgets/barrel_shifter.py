"""The barrel shifter: a u32 shifted or rotated by a per-row amount.

The port of `binius_tpu/m3/gadgets/barrel_shifter.py`: five mux stages,
stage k choosing between the value so far and that value shifted by 2^k,
by bit k of the amount. The amount's bits are committed columns of 32
values per row, each boolean and the same in all 32 values of a row
(equal to its rotation by one). Its witness (`populate`) is computed on
numpy words for all rows at once, with the JAX module's values; the
seeded instance that `chip_smoke.py` and the tests prove holds the three
kinds on one input column.
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
M32 = 0xFFFFFFFF

LOGICAL_LEFT = "logical_left"     # value << amount
LOGICAL_RIGHT = "logical_right"   # value >> amount
CIRCULAR_LEFT = "circular_left"   # rotate left by amount

# the instance's shifters: (gadget name, kind)
KINDS = (("rotl", CIRCULAR_LEFT), ("shl", LOGICAL_LEFT), ("shr", LOGICAL_RIGHT))


def _stage_shift(t: TableBuilder, name: str, col: Col, offset: int, kind: str) -> Col:
    """The integer shift of a u32 column (bit z at value index z) is the
    column shift of the same name: value << o is LogicalLeft(o), value >> o
    LogicalRight(o), a left rotation CircularLeft(o)."""
    variant = {LOGICAL_LEFT: shift_ind.LOGICAL_LEFT, LOGICAL_RIGHT: shift_ind.LOGICAL_RIGHT,
               CIRCULAR_LEFT: shift_ind.CIRCULAR_LEFT}[kind]
    return t.add_shifted(name, col, offset, LOG_U32, variant)


def shift_words(v: np.ndarray, offset: int, kind: str) -> np.ndarray:
    """u32 words (in uint64) shifted or rotated by `offset` bits."""
    o = np.uint64(offset)
    if kind == LOGICAL_LEFT:
        return (v << o) & np.uint64(M32)
    if kind == LOGICAL_RIGHT:
        return v >> o
    if kind == CIRCULAR_LEFT:
        return ((v << o) | (v >> np.uint64(32 - offset))) & np.uint64(M32)
    raise ValueError(kind)


@dataclasses.dataclass
class BarrelShifter:
    input: Col
    shift_bits: list   # 5 committed bit columns, constant within a row
    stages: list       # the committed stage outputs
    output: Col

    @staticmethod
    def build(t: TableBuilder, name: str, input_col: Col,
              kind: str = CIRCULAR_LEFT) -> "BarrelShifter":
        shift_bits, stages = [], []
        cur = input_col
        for k in range(5):
            b = t.add_committed(f"{name}.bit{k}", 0, LOG_U32)
            shift_bits.append(b)
            # boolean and row-constant: b * (1 + b) = 0 and b = rot(b, 1)
            t.assert_zero(f"{name}.bit{k}.bool", [b], V(0) * (ArithExpr.const(1) + V(0)))
            b_rot = t.add_shifted(f"{name}.bit{k}.rot", b, 1, LOG_U32, shift_ind.CIRCULAR_LEFT)
            t.assert_zero(f"{name}.bit{k}.const", [b, b_rot], V(0) + V(1))
            shifted = _stage_shift(t, f"{name}.s{k}.shift", cur, 1 << k, kind)
            out = t.add_committed(f"{name}.s{k}.out", 0, LOG_U32)
            # out = b ? shifted : cur
            t.assert_zero(f"{name}.s{k}.mux", [out, b, shifted, cur],
                          V(0) + V(1) * V(2) + (ArithExpr.const(1) + V(1)) * V(3))
            stages.append(out)
            cur = out
        return BarrelShifter(input_col, shift_bits, stages, cur)

    def populate(self, tw, in_rows, amount_rows, kind: str) -> np.ndarray:
        """Fill the amount bits and the stage outputs from per-row u32
        inputs and amounts (0-31); returns the outputs."""
        cur = np.asarray(in_rows, dtype=np.uint64)
        amounts = np.asarray(amount_rows, dtype=np.uint64)
        for k, (b_col, s_col) in enumerate(zip(self.shift_bits, self.stages)):
            bit = (amounts >> np.uint64(k)) & np.uint64(1)
            tw.set_packed_ints(b_col, bit * np.uint64(M32))
            cur = np.where(bit == 1, shift_words(cur, 1 << k, kind), cur)
            tw.set_packed_ints(s_col, cur)
        return cur


def barrel_shifter_inputs(log_rows: int, seed: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """From numpy's `default_rng(seed)`: 2^log_rows u32 inputs x, then the
    amounts (0-31) of rotl, shl and shr, 2^log_rows each."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, 1 << log_rows, dtype=np.uint64)
    return x, [rng.integers(0, 32, 1 << log_rows, dtype=np.uint64) for _ in KINDS]


def barrel_shifter_system(log_rows: int, x, amounts, device=None):
    """The one-table ("barrel_shifter") system of 2^log_rows rows: the u32
    column xin and its three shifters (`KINDS`), each by its own amounts,
    and its witness on `device` (CUDA unless named): returns (core system,
    witness)."""
    with tracing.span("frontend/compile", root=True):
        m3 = M3ConstraintSystem()
        t = m3.add_table("barrel_shifter")
        xin = t.add_committed("xin", 0, LOG_U32)
        gadgets = [BarrelShifter.build(t, name, xin, kind) for name, kind in KINDS]
        core, omap = m3.compile([log_rows])
    with tracing.span("frontend/witness", root=True):
        wi = WitnessIndex(m3, [log_rows])
        tw = wi.table(0)
        tw.set_packed_ints(xin, x)
        for g, (_, kind), a in zip(gadgets, KINDS, amounts):
            g.populate(tw, x, a, kind)
    return core, wi.to_core_witness(core, omap, device)
