"""The Grøstl P/Q permutation gadget over the canonical tower B8.

The port of `SBox`, `PermutationRound` and `Permutation` of
`binius_tpu/m3/gadgets/groestl.py`, with their numpy trace generation.
The 8x8-byte state is held transposed as 8 columns of 8 B8 values per row
(column i = state row i), so ShiftBytes is an in-row circular shift. Each
round is AddRoundConstant + SubBytes (committed inversion bits + an
F2-affine output) + ShiftBytes (shifted oracles) + MixBytes (a linear
combination).

The Rijndael/Grøstl constants are derived: the AES-basis affine S-box
matrix and the MixBytes scalars are conjugated into the canonical tower
through the AES <-> tower isomorphism (`fields/isomorphism.py`). Field
inversion commutes with the isomorphism, so the S-box witness is a plain
tower-B8 inversion. `groestl_inputs` and `groestl_system` make the seeded
instances that `chip_smoke.py` and the tests prove.
"""

from __future__ import annotations

import dataclasses
import functools
import random

import numpy as np

from ...fields import scalar
from ...fields.isomorphism import aes_to_canonical_b8_matrix, canonical_to_aes_b8_matrix
from ...hash.groestl import MIX, SHIFTS_P, SHIFTS_Q
from ...math.arith import ArithExpr
from ...protocols import shift_ind
from ..builder.table import Col, M3ConstraintSystem, TableBuilder
from ..builder.witness import WitnessIndex

V = ArithExpr.var
LOG_STATE_ROW = 3  # 8 bytes per table row per column
N_ROUNDS = 10


def _to_tower(x_aes: int) -> int:
    return scalar.apply_linmap(aes_to_canonical_b8_matrix(), x_aes)


def _from_tower(x_t: int) -> int:
    return scalar.apply_linmap(canonical_to_aes_b8_matrix(), x_t)


def _aes_affine(x: int) -> int:
    """The Rijndael S-box affine layer in the AES basis: A*x + 0x63 with
    A = I + rotl^1 + rotl^2 + rotl^3 + rotl^4."""
    def rotl(v, r):
        return ((v << r) | (v >> (8 - r))) & 0xFF
    return x ^ rotl(x, 1) ^ rotl(x, 2) ^ rotl(x, 3) ^ rotl(x, 4) ^ 0x63


@functools.lru_cache(maxsize=None)
def sbox_tower_matrix_cols() -> tuple:
    """Columns of the affine layer conjugated to the tower basis."""
    return tuple(_to_tower(_aes_affine(_from_tower(1 << j)) ^ 0x63) for j in range(8))


@functools.lru_cache(maxsize=None)
def sbox_tower_offset() -> int:
    return _to_tower(0x63)


@functools.lru_cache(maxsize=None)
def mix_tower_scalars() -> tuple:
    """The MixBytes circulant's first column in the tower basis."""
    return tuple(_to_tower(m) for m in MIX)


def round_consts_tower(rnd: int) -> tuple:
    """The P permutation's round constants of round `rnd`, one per column."""
    return tuple(_to_tower((i * 0x10) ^ rnd) for i in range(8))


# -- 256-entry B8 tables for the trace generation ----------------------------

@functools.lru_cache(maxsize=None)
def _inv8_table() -> np.ndarray:
    return scalar.b8_invert_table()


@functools.lru_cache(maxsize=None)
def _sbox_out_table() -> np.ndarray:
    """Inverse value -> affine S-box output."""
    cols, off = sbox_tower_matrix_cols(), sbox_tower_offset()
    return np.array([off ^ scalar.apply_linmap(cols, v) for v in range(256)], dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _mul8_table(m: int) -> np.ndarray:
    return np.array([scalar.mul(3, m, v) for v in range(256)], dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _to_tower_table() -> np.ndarray:
    return np.array([_to_tower(v) for v in range(256)], dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _from_tower_table() -> np.ndarray:
    return np.array([_from_tower(v) for v in range(256)], dtype=np.uint8)


@dataclasses.dataclass
class SBox:
    """The Rijndael S-box over tower B8: committed inversion bits, the
    inverse-validity constraints and the affine output."""

    inv_bits: list
    inv: Col
    output: Col

    @staticmethod
    def build(t: TableBuilder, name: str, input_cols: list, input_expr: ArithExpr,
              group: str) -> "SBox":
        inv_bits = [t.add_committed(f"{name}.ib{j}", 0, LOG_STATE_ROW) for j in range(8)]
        pack = None
        for j in range(8):
            term = V(j) * ArithExpr.const(1 << j, 3)
            pack = term if pack is None else pack + term
        inv = t.add_computed(f"{name}.inv", pack, inv_bits)

        k = len(input_cols)
        x = input_expr
        iv = V(k)
        # x * inv^2 = inv  and  x^2 * inv = x
        t.assert_zero(f"{name}.inv_or_inv0", [*input_cols, inv], x * iv * iv + iv, group=group)
        t.assert_zero(f"{name}.inv_or_x0", [*input_cols, inv], x * x * iv + x, group=group)

        cols = sbox_tower_matrix_cols()
        out_expr = ArithExpr.const(sbox_tower_offset(), 3)
        for j in range(8):
            out_expr = out_expr + V(j) * ArithExpr.const(cols[j], 3)
        output = t.add_computed(f"{name}.out", out_expr, inv_bits)
        return SBox(inv_bits, inv, output)

    def populate(self, tw, in_vals) -> np.ndarray:
        """in_vals: flat tower-B8 values, one per state-row slot; returns
        the S-box outputs (uint8)."""
        inv = _inv8_table()[np.asarray(in_vals, dtype=np.uint8)]
        for j in range(8):
            tw.set_column(self.inv_bits[j], ((inv >> j) & 1).astype(np.uint32))
        return _sbox_out_table()[inv]


@dataclasses.dataclass
class PermutationRound:
    variant: str  # "P" | "Q"
    rnd: int
    state_in: list
    round_const: Col
    sbox: list
    shift: list
    state_out: list

    @staticmethod
    def build(t: TableBuilder, name: str, variant: str, state_in: list,
              rnd: int) -> "PermutationRound":
        round_const = t.add_fixed(f"{name}.rc", 3, list(round_consts_tower(rnd)), LOG_STATE_ROW)
        ff = _to_tower(0xFF)

        sboxes = []
        for i in range(8):
            if variant == "P":
                if i == 0:
                    cols, expr = [state_in[0], round_const], V(0) + V(1)
                else:
                    cols, expr = [state_in[i]], V(0)
            elif i == 7:
                cols = [state_in[7], round_const]
                expr = V(0) + V(1) + ArithExpr.const(ff, 3)
            else:
                cols, expr = [state_in[i]], V(0) + ArithExpr.const(ff, 3)
            sboxes.append(SBox.build(t, f"{name}.sb{i}", cols, expr, group=f"{name}.sbox"))

        shifts_tbl = SHIFTS_P if variant == "P" else SHIFTS_Q
        shift = []
        for i in range(8):
            # row i rotates left by shifts_tbl[i]: out[j] = in[(j + s) % 8],
            # and CIRCULAR_LEFT(o) is out[j] = in[(j - o) % 8], so o = (8 - s) % 8
            off = (8 - shifts_tbl[i]) % 8
            if off == 0:
                shift.append(sboxes[i].output)
            else:
                shift.append(t.add_shifted(f"{name}.sh{i}", sboxes[i].output, off,
                                           LOG_STATE_ROW, shift_ind.CIRCULAR_LEFT))

        mix = mix_tower_scalars()
        state_out = []
        for j in range(8):
            expr = None
            for i in range(8):
                term = V(i) * ArithExpr.const(mix[(8 + i - j) % 8], 3)
                expr = term if expr is None else expr + term
            state_out.append(t.add_computed(f"{name}.mix{j}", expr, shift))
        return PermutationRound(variant, rnd, state_in, round_const, sboxes, shift, state_out)

    def populate(self, tw, state_rows: list) -> list:
        """state_rows[i]: flat uint8 tower values of column i (table row r,
        slot j at r*8 + j). Returns the round's output columns."""
        rc = np.array(round_consts_tower(self.rnd), dtype=np.uint8)
        ff = np.uint8(_to_tower(0xFF))
        rc_tiled = np.tile(rc, len(state_rows[0]) // 8)
        sb_out = []
        for i in range(8):
            vals = np.asarray(state_rows[i], dtype=np.uint8)
            if self.variant == "P":
                if i == 0:
                    vals = vals ^ rc_tiled
            else:
                vals = (vals ^ rc_tiled ^ ff) if i == 7 else vals ^ ff
            sb_out.append(self.sbox[i].populate(tw, vals))

        shifts_tbl = SHIFTS_P if self.variant == "P" else SHIFTS_Q
        shifted = [np.roll(sb_out[i].reshape(-1, 8), -shifts_tbl[i], axis=1).reshape(-1)
                   for i in range(8)]
        mix = mix_tower_scalars()
        out_rows = []
        for j in range(8):
            col = np.zeros(len(shifted[0]), dtype=np.uint8)
            for i in range(8):
                col ^= _mul8_table(mix[(8 + i - j) % 8])[shifted[i]]
            out_rows.append(col)
        return out_rows


@dataclasses.dataclass
class Permutation:
    """A whole 10-round Grøstl-256 P or Q permutation."""

    variant: str
    rounds: list

    @staticmethod
    def build(t: TableBuilder, name: str, variant: str, state_in: list = None) -> "Permutation":
        assert variant in ("P", "Q")
        if state_in is None:
            state_in = [t.add_committed(f"{name}.in{i}", 3, LOG_STATE_ROW) for i in range(8)]
        rounds = []
        cur = state_in
        for r in range(N_ROUNDS):
            pr = PermutationRound.build(t, f"{name}.r{r}", variant, cur, r)
            rounds.append(pr)
            cur = pr.state_out
        return Permutation(variant, rounds)

    @property
    def state_in(self) -> list:
        return self.rounds[0].state_in

    @property
    def state_out(self) -> list:
        return self.rounds[-1].state_out

    def populate(self, tw, states_aes) -> np.ndarray:
        """states_aes: per table row an 8x8 state of AES-basis bytes (the
        spec layout of `hash/groestl.py`), as a list or an (n, 8, 8) uint8
        array. Fills the committed input columns and every round's
        witness; returns the (n, 8, 8) output states (AES basis)."""
        st = np.asarray(states_aes, dtype=np.uint8)
        n_rows = st.shape[0]
        tower_st = _to_tower_table()[st]   # (n, 8 state rows, 8 columns)
        state_rows = [np.ascontiguousarray(tower_st[:, i, :]).reshape(-1) for i in range(8)]
        for i in range(8):
            tw.set_column(self.state_in[i], state_rows[i].astype(np.uint32))
        cur = state_rows
        for pr in self.rounds:
            cur = pr.populate(tw, cur)
        return _from_tower_table()[np.stack([c.reshape(n_rows, 8) for c in cur], axis=1)]


def groestl_inputs(log_n: int, seed: int) -> np.ndarray:
    """(2^log_n, 8, 8) uint8 random states, each drawn row-major from
    `random.Random(seed).getrandbits(8)` (as `examples/groestl.py` draws
    them)."""
    rng = random.Random(seed)
    n = 1 << log_n
    return np.array([rng.getrandbits(8) for _ in range(n * 64)], dtype=np.uint8).reshape(n, 8, 8)


def groestl_system(log_n: int, states, device=None):
    """`examples/groestl.py`'s one-table system of 2^log_n P permutations
    of the given states, and its witness on `device` (CUDA unless named):
    returns (core system, witness, output states)."""
    m3 = M3ConstraintSystem()
    t = m3.add_table("groestl_p")
    g = Permutation.build(t, "perm", "P")
    core, omap = m3.compile([log_n])
    wi = WitnessIndex(m3, [log_n])
    outs = g.populate(wi.table(0), states)
    return core, wi.to_core_witness(core, omap, device), outs
