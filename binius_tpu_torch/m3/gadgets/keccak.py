"""The Keccak-f[1600] permutation gadget, all 24 rounds stacked in a row.

The port of `KeccakF` of `binius_tpu/m3/gadgets/keccak.py`, with its
numpy trace generation. One permutation per table row; every lane is a B1
column of 64 values per row (z = value index). Per round:

  * theta: C[x] (a 5-lane XOR) and AfterTheta[x,y] = A + C[x-1] +
    rot(C[x+1], 1) are linear: computed and shifted virtual columns;
  * rho and pi: B[pi(x,y)] = rot(AfterTheta[x,y], r[x,y]), circular-shift
    virtual columns (a rotation left by n is the CIRCULAR_LEFT offset n);
  * chi and iota: the next state is committed with the constraint
    A' + B0 + (1 + B1) * B2 (+ the RC pattern for lane (0,0)) = 0, one
    constraint per lane per round.

`KeccakFLookedup` is the variant whose chi goes through a lookup channel
instead of constraints: each lane-round pulls one merged column from the
4-row bit-AND table, and the permutation has no zero constraint at all;
`KeccakLookedupCS` is its two-table system (the keccak table and the
bit-AND table).

`keccak_inputs`, `keccak_system` and `keccak_lookups_system` make the
seeded instances that `chip_smoke.py` and the tests prove.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

from ...math.arith import ArithExpr
from ...protocols import shift_ind
from ..builder.table import Col, M3ConstraintSystem, TableBuilder
from ..builder.witness import WitnessIndex

LOG_LANE = 6  # 64 bits per lane
N_ROUNDS = 24

RHO = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]  # RHO[x][y]

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def keccak_f(lanes: list[int]) -> list[int]:
    """The permutation on 25 lane ints (index x + 5*y), on the host."""
    a = list(lanes)
    M = (1 << 64) - 1

    def rot(v, n):
        n %= 64
        return ((v << n) | (v >> (64 - n))) & M

    for r in range(N_ROUNDS):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ rot(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rot(a[x + 5 * y], RHO[x][y])
        a = [b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y])
             for y in range(5) for x in range(5)]
        a[0] ^= RC[r]
    return a


def _rot_col(t: TableBuilder, name: str, col: Col, n: int) -> Col:
    """Circular rotate-left by n within each 64-value lane block."""
    n %= 64
    if n == 0:
        return col
    return t.add_shifted(name, col, n, LOG_LANE, shift_ind.CIRCULAR_LEFT)


@dataclasses.dataclass
class KeccakF:
    state_in: list   # 25 committed Cols (x + 5*y)
    state_out: list  # 25 Cols of the final round
    rounds_out: list  # per round: 25 committed Cols

    @staticmethod
    def build(t: TableBuilder, name: str, state_in: list) -> "KeccakF":
        V = ArithExpr.var
        a = list(state_in)
        rounds_out = []
        for r in range(N_ROUNDS):
            # theta
            c_cols = []
            for x in range(5):
                cols = [a[x + 5 * y] for y in range(5)]
                expr = V(0) + V(1) + V(2) + V(3) + V(4)
                c_cols.append(t.add_computed(f"{name}.r{r}.C{x}", expr, cols))
            rot_c = [_rot_col(t, f"{name}.r{r}.rotC{x}", c_cols[x], 1) for x in range(5)]
            after_theta = []
            for y in range(5):
                for x in range(5):
                    cols = [a[x + 5 * y], c_cols[(x + 4) % 5], rot_c[(x + 1) % 5]]
                    expr = V(0) + V(1) + V(2)
                    after_theta.append(t.add_computed(f"{name}.r{r}.T{x}_{y}", expr, cols))
            # rho + pi
            b = [None] * 25
            for x in range(5):
                for y in range(5):
                    src = after_theta[x + 5 * y]
                    b[y + 5 * ((2 * x + 3 * y) % 5)] = _rot_col(
                        t, f"{name}.r{r}.B{x}_{y}", src, RHO[x][y])
            # chi (+ iota on lane 0) into the committed next state
            rc_pattern = [(RC[r] >> z) & 1 for z in range(64)]
            rc_col = t.add_fixed(f"{name}.r{r}.RC", 0, rc_pattern, LOG_LANE)
            nxt = []
            for y in range(5):
                for x in range(5):
                    out = t.add_committed(f"{name}.r{r}.A{x}_{y}", 0, LOG_LANE)
                    nxt.append(out)
                    b0 = b[x + 5 * y]
                    b1 = b[(x + 1) % 5 + 5 * y]
                    b2 = b[(x + 2) % 5 + 5 * y]
                    if x == 0 and y == 0:
                        cols = [out, b0, b1, b2, rc_col]
                        expr = V(0) + V(1) + (ArithExpr.const(1) + V(2)) * V(3) + V(4)
                    else:
                        cols = [out, b0, b1, b2]
                        expr = V(0) + V(1) + (ArithExpr.const(1) + V(2)) * V(3)
                    t.assert_zero(f"{name}.r{r}.chi{x}_{y}", cols, expr, group=f"{name}.r{r}")
            a = nxt
            rounds_out.append(nxt)
        return KeccakF(list(state_in), a, rounds_out)

    def populate(self, tw, input_lanes_rows) -> list:
        """Fill every committed column from per-row input lanes (a list of
        25-lane lists, or a (rows, 25) uint64 array); returns the per-row
        output lanes. Vectorized over rows with numpy uint64 lanes."""
        def rot(v, k):
            k %= 64
            if k == 0:
                return v
            return (v << np.uint64(k)) | (v >> np.uint64(64 - k))

        inp = np.asarray(input_lanes_rows, dtype=np.uint64)
        a = inp.T.copy()  # (25, n_rows)
        for i, col in enumerate(self.state_in):
            tw.set_packed_ints(col, inp[:, i])
        for r in range(N_ROUNDS):
            c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
            d = [c[(x - 1) % 5] ^ rot(c[(x + 1) % 5], 1) for x in range(5)]
            at = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
            b = [None] * 25
            for x in range(5):
                for y in range(5):
                    b[y + 5 * ((2 * x + 3 * y) % 5)] = rot(at[x + 5 * y], RHO[x][y])
            a = np.stack([b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y])
                          for y in range(5) for x in range(5)])
            a[0] ^= np.uint64(RC[r])
            for i, col in enumerate(self.rounds_out[r]):
                tw.set_packed_ints(col, a[i])
        return [[int(v) for v in row] for row in a.T]


def keccak_inputs(log_n: int, seed: int) -> list[list[int]]:
    """2^log_n permutation inputs of 25 random lanes, drawn from
    `random.Random(seed)` (as `examples/keccak.py` draws them)."""
    rng = random.Random(seed)
    return [[rng.getrandbits(64) for _ in range(25)] for _ in range(1 << log_n)]


def keccak_system(log_n: int, inputs, device=None):
    """`examples/keccak.py`'s one-table system of 2^log_n permutations of
    the given inputs, and its witness on `device` (CUDA unless named):
    returns (core system, witness, output lanes per row)."""
    m3 = M3ConstraintSystem()
    t = m3.add_table("keccak")
    state_in = [t.add_committed(f"in{i}", 0, LOG_LANE) for i in range(25)]
    gadget = KeccakF.build(t, "kf", state_in)
    core, omap = m3.compile([log_n])
    wi = WitnessIndex(m3, [log_n])
    outs = gadget.populate(wi.table(0), inputs)
    return core, wi.to_core_witness(core, omap, device), outs


# ---------------------------------------------------------------------------
# the lookup variant: chi through a bit-AND lookup channel
# ---------------------------------------------------------------------------

def bit_and_index(a: int, b: int) -> int:
    """Index of the bit pair (a, b) in the 4-row bit-AND table."""
    return a | (b << 1)


def _popcount(v: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(v).view(np.uint8)).sum())


@dataclasses.dataclass
class KeccakFLookedup:
    """Keccak-f[1600] with chi checked by lookups: with the round output
    committed, the pulled merged value

        1 + B1 + 2*B2 + 4*(out + B0 [+ RC])

    lies in the bit-AND table exactly when out + B0 [+ RC] = (1 + B1) & B2,
    which is chi (and iota on lane (0, 0)). Theta, rho and pi stay virtual
    columns, so the permutation has no zero constraint: its nonlinearity
    is in the channel's grand product. Each lane-round is one pull of 64
    values per row."""

    state_in: list
    state_out: list
    rounds_out: list
    merged_cols: list  # the 600 pulled columns, round-major

    @staticmethod
    def build(t: TableBuilder, name: str, state_in: list,
              lookup_channel: int) -> "KeccakFLookedup":
        V = ArithExpr.var

        def C(v):
            return ArithExpr.const(v, 7)

        a = list(state_in)
        rounds_out = []
        merged_cols = []
        for r in range(N_ROUNDS):
            c_cols = []
            for x in range(5):
                cols = [a[x + 5 * y] for y in range(5)]
                c_cols.append(t.add_computed(f"{name}.r{r}.C{x}",
                                             V(0) + V(1) + V(2) + V(3) + V(4), cols))
            rot_c = [_rot_col(t, f"{name}.r{r}.rotC{x}", c_cols[x], 1) for x in range(5)]
            after_theta = []
            for y in range(5):
                for x in range(5):
                    cols = [a[x + 5 * y], c_cols[(x + 4) % 5], rot_c[(x + 1) % 5]]
                    after_theta.append(t.add_computed(f"{name}.r{r}.T{x}_{y}",
                                                      V(0) + V(1) + V(2), cols))
            b = [None] * 25
            for x in range(5):
                for y in range(5):
                    b[y + 5 * ((2 * x + 3 * y) % 5)] = _rot_col(
                        t, f"{name}.r{r}.B{x}_{y}", after_theta[x + 5 * y], RHO[x][y])
            rc_col = t.add_fixed(f"{name}.r{r}.RC", 0, [(RC[r] >> z) & 1 for z in range(64)],
                                 LOG_LANE)
            nxt = []
            for y in range(5):
                for x in range(5):
                    out = t.add_committed(f"{name}.r{r}.A{x}_{y}", 0, LOG_LANE)
                    nxt.append(out)
                    b0 = b[x + 5 * y]
                    b1 = b[(x + 1) % 5 + 5 * y]
                    b2 = b[(x + 2) % 5 + 5 * y]
                    if x == 0 and y == 0:
                        cols = [b1, b2, out, b0, rc_col]
                        expr = C(1) + V(0) + C(2) * V(1) + C(4) * (V(2) + V(3) + V(4))
                    else:
                        cols = [b1, b2, out, b0]
                        expr = C(1) + V(0) + C(2) * V(1) + C(4) * (V(2) + V(3))
                    merged = t.add_computed(f"{name}.r{r}.m{x}_{y}", expr, cols)
                    merged_cols.append(merged)
                    t.pull(lookup_channel, [merged])
            a = nxt
            rounds_out.append(nxt)
        return KeccakFLookedup(list(state_in), a, rounds_out, merged_cols)

    def populate(self, tw, input_lanes_rows):
        """Fill the committed columns from per-row input lanes (a list of
        25-lane lists, or a (rows, 25) uint64 array); returns (the per-row
        output lanes, the bit-AND table's index counts). Vectorized over
        rows; the counts of chi's bit pairs come from popcounts."""
        def rot(v, k):
            k %= 64
            if k == 0:
                return v
            return (v << np.uint64(k)) | (v >> np.uint64(64 - k))

        inp = np.asarray(input_lanes_rows, dtype=np.uint64)
        a = inp.T.copy()  # (25, n_rows)
        counts = [0, 0, 0, 0]
        for i, col in enumerate(self.state_in):
            tw.set_packed_ints(col, inp[:, i])
        for r in range(N_ROUNDS):
            c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
            d = [c[(x - 1) % 5] ^ rot(c[(x + 1) % 5], 1) for x in range(5)]
            at = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
            b = [None] * 25
            for x in range(5):
                for y in range(5):
                    b[y + 5 * ((2 * x + 3 * y) % 5)] = rot(at[x + 5 * y], RHO[x][y])
            for y in range(5):
                for x in range(5):
                    nb1 = ~b[(x + 1) % 5 + 5 * y]
                    b2 = b[(x + 2) % 5 + 5 * y]
                    n11 = _popcount(nb1 & b2)
                    n10 = _popcount(nb1 & ~b2)
                    n01 = _popcount(~nb1 & b2)
                    counts[bit_and_index(1, 1)] += n11
                    counts[bit_and_index(1, 0)] += n10
                    counts[bit_and_index(0, 1)] += n01
                    counts[bit_and_index(0, 0)] += 64 * b2.size - n11 - n10 - n01
            a = np.stack([b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y])
                          for y in range(5) for x in range(5)])
            a[0] ^= np.uint64(RC[r])
            for i, col in enumerate(self.rounds_out[r]):
                tw.set_packed_ints(col, a[i])
        return [[int(v) for v in row] for row in a.T], counts


@dataclasses.dataclass
class KeccakLookedupCS:
    """The two-table system: the keccak table with `KeccakFLookedup`, and
    the 4-row bit-AND lookup table (`indexed_lookup.BitAndLookup` with
    n_bits = 1: structured entries, a committed sorted copy, the
    permutation channel and a LookupProducer)."""

    m3: object
    keccak_table: object
    gadget: KeccakFLookedup
    state_in: list
    lookup: object
    lookup_table: object = None

    @staticmethod
    def build(m3, log_n_permutations: int, n_multiplicity_bits: int = None) -> "KeccakLookedupCS":
        from .indexed_lookup import BitAndLookup

        lookup_ch = m3.add_channel()
        perm_ch = m3.add_channel()
        t = m3.add_table("keccak_lookedup")
        state_in = [t.add_committed(f"in{i}", 0, LOG_LANE) for i in range(25)]
        gadget = KeccakFLookedup.build(t, "kf", state_in, lookup_ch)
        tl = m3.add_table("bitand_table")
        if n_multiplicity_bits is None:
            # the counts sum to n_perms * 24 * 25 * 64 over the 4 indices
            n_multiplicity_bits = log_n_permutations + 16
        lookup = BitAndLookup.build(tl, lookup_ch, perm_ch, n_multiplicity_bits, n_bits=1)
        return KeccakLookedupCS(m3, t, gadget, state_in, lookup, tl)

    def table_sizes(self, n_permutations: int) -> list[int]:
        return [n_permutations, 4]

    def populate(self, wi, input_lanes_rows) -> list:
        outs, counts = self.gadget.populate(wi.table(self.keccak_table.table_id),
                                            input_lanes_rows)
        self.lookup.populate(wi.table(self.lookup_table.table_id),
                             [(i, counts[i]) for i in range(4)])
        return outs


def keccak_lookups_system(n_permutations: int, inputs, device=None):
    """`examples/keccak_lookups.py`'s system of `n_permutations` of the given
    inputs (its multiplicity bits sized for the power of two that holds
    them), and its witness on `device` (CUDA unless named): returns (core
    system, witness, table sizes, output lanes per row)."""
    m3 = M3ConstraintSystem()
    cs = KeccakLookedupCS.build(m3, max(0, (n_permutations - 1).bit_length()))
    sizes = cs.table_sizes(n_permutations)
    core, omap = m3.compile_sizes(sizes)
    wi = WitnessIndex.with_sizes(m3, sizes)
    outs = cs.populate(wi, inputs)
    return core, wi.to_core_witness(core, omap, device), sizes, outs
