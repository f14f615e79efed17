"""The SHA-256 compression gadget: one compression per table row.

The port of `binius_tpu/m3/gadgets/sha256.py`. Every u32 word is a B1
column of 32 values per row (bit z at value index z). Rotations and
shifts are shifted oracles, XORs computed (linear) columns, Ch and Maj
committed columns with degree-2 constraints, and the additions the ripple
`U32Add` gadget. `populate` replays the circuit over all rows at once on
numpy uint32 words. `sha256_inputs` and `sha256_system` make the seeded
instances of `examples/sha256.py` that `chip_smoke.py` and the tests
prove.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

from ...math.arith import ArithExpr
from ...protocols import shift_ind
from ...utils import tracing
from ..builder.table import Col, M3ConstraintSystem, TableBuilder
from ..builder.witness import WitnessIndex
from .arith import LOG_U32, U32Add

V = ArithExpr.var

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def _rotr(t: TableBuilder, name: str, col: Col, n: int) -> Col:
    """ROTR n: out bit z = in bit (z + n) % 32, a CIRCULAR_LEFT shift by
    32 - n."""
    n %= 32
    if n == 0:
        return col
    return t.add_shifted(name, col, (32 - n) % 32, LOG_U32, shift_ind.CIRCULAR_LEFT)


def _shr(t: TableBuilder, name: str, col: Col, n: int) -> Col:
    """SHR n: out bit z = in bit z + n, a LOGICAL_RIGHT shift by n."""
    return t.add_shifted(name, col, n, LOG_U32, shift_ind.LOGICAL_RIGHT)


def _xor3(t: TableBuilder, name: str, a: Col, b: Col, c: Col) -> Col:
    return t.add_computed(name, V(0) + V(1) + V(2), [a, b, c])


def _word_pattern(v: int) -> list:
    return [(v >> z) & 1 for z in range(32)]


@dataclasses.dataclass
class Sha256:
    msg: list        # the 16 committed message word Cols
    state_out: list  # the 8 digest word Cols (the final state plus the IV)
    adders: list
    ch_cols: list
    maj_cols: list
    w_cols: list     # the 64 schedule words (the first 16 the message)

    @staticmethod
    def build(t: TableBuilder, name: str, msg: list) -> "Sha256":
        adders, ch_cols, maj_cols = [], [], []

        def add(nm, x, y):
            g = U32Add.build(t, nm, x, y)
            adders.append(g)
            return g.zout

        w = list(msg)
        for i in range(16, 64):
            s0 = _xor3(t, f"{name}.w{i}.s0",
                       _rotr(t, f"{name}.w{i}.s0a", w[i - 15], 7),
                       _rotr(t, f"{name}.w{i}.s0b", w[i - 15], 18),
                       _shr(t, f"{name}.w{i}.s0c", w[i - 15], 3))
            s1 = _xor3(t, f"{name}.w{i}.s1",
                       _rotr(t, f"{name}.w{i}.s1a", w[i - 2], 17),
                       _rotr(t, f"{name}.w{i}.s1b", w[i - 2], 19),
                       _shr(t, f"{name}.w{i}.s1c", w[i - 2], 10))
            x = add(f"{name}.w{i}.a1", w[i - 16], s0)
            y = add(f"{name}.w{i}.a2", x, w[i - 7])
            w.append(add(f"{name}.w{i}.a3", y, s1))

        # the working variables start as the IV (fixed columns)
        state = [t.add_fixed(f"{name}.iv{j}", 0, _word_pattern(IV[j]), LOG_U32)
                 for j in range(8)]
        for r in range(64):
            a, b, c, d, e, f, g, h = state
            S1 = _xor3(t, f"{name}.r{r}.S1",
                       _rotr(t, f"{name}.r{r}.S1a", e, 6),
                       _rotr(t, f"{name}.r{r}.S1b", e, 11),
                       _rotr(t, f"{name}.r{r}.S1c", e, 25))
            ch = t.add_committed(f"{name}.r{r}.ch", 0, LOG_U32)
            t.assert_zero(f"{name}.r{r}.ch.def", [ch, e, f, g],
                          V(0) + V(1) * V(2) + (ArithExpr.const(1) + V(1)) * V(3),
                          group=f"{name}.chmaj")
            kc = t.add_fixed(f"{name}.r{r}.K", 0, _word_pattern(K[r]), LOG_U32)
            t1a = add(f"{name}.r{r}.t1a", h, S1)
            t1b = add(f"{name}.r{r}.t1b", t1a, ch)
            t1c = add(f"{name}.r{r}.t1c", t1b, kc)
            t1 = add(f"{name}.r{r}.t1", t1c, w[r])
            S0 = _xor3(t, f"{name}.r{r}.S0",
                       _rotr(t, f"{name}.r{r}.S0a", a, 2),
                       _rotr(t, f"{name}.r{r}.S0b", a, 13),
                       _rotr(t, f"{name}.r{r}.S0c", a, 22))
            maj = t.add_committed(f"{name}.r{r}.maj", 0, LOG_U32)
            t.assert_zero(f"{name}.r{r}.maj.def", [maj, a, b, c],
                          V(0) + V(1) * V(2) + V(1) * V(3) + V(2) * V(3),
                          group=f"{name}.chmaj")
            t2 = add(f"{name}.r{r}.t2", S0, maj)
            e_new = add(f"{name}.r{r}.e", d, t1)
            a_new = add(f"{name}.r{r}.a", t1, t2)
            ch_cols.append(ch)
            maj_cols.append(maj)
            state = [a_new, a, b, c, e_new, e, f, g]
        out = []
        for j in range(8):
            iv_col = t.add_fixed(f"{name}.out_iv{j}", 0, _word_pattern(IV[j]), LOG_U32)
            out.append(add(f"{name}.out{j}", state[j], iv_col))
        return Sha256(list(msg), out, adders, ch_cols, maj_cols, w)

    def populate(self, tw, msg_rows) -> np.ndarray:
        """msg_rows: per row the 16 message words ((n, 16) or a list of
        rows). Fills every committed column but the message's; returns the
        (n, 8) uint32 digest words."""
        U = np.uint32

        def rotr(v, n):
            n %= 32
            return v if n == 0 else (v >> U(n)) | (v << U(32 - n))

        msg = np.asarray(msg_rows, dtype=np.uint64).astype(U)
        n_rows = msg.shape[0]
        inputs = []

        def add(x, y):
            inputs.append((x, y))
            return x + y  # wraps mod 2^32

        w = [msg[:, i] for i in range(16)]
        for i in range(16, 64):
            s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> U(3))
            s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> U(10))
            w.append(add(add(add(w[i - 16], s0), w[i - 7]), s1))
        a, b, c, d, e, f, g, h = (np.full(n_rows, U(v)) for v in IV)
        ch_vals, maj_vals = [], []
        for r in range(64):
            S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            ch_vals.append(ch)
            t1 = add(add(add(add(h, S1), ch), np.full(n_rows, U(K[r]))), w[r])
            S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            maj_vals.append(maj)
            t2 = add(S0, maj)
            e_new = add(d, t1)
            a_new = add(t1, t2)
            a, b, c, d, e, f, g, h = a_new, a, b, c, e_new, e, f, g
        digest = [add(s, np.full(n_rows, U(IV[j])))
                  for j, s in enumerate([a, b, c, d, e, f, g, h])]
        assert len(inputs) == len(self.adders)
        for gadget, (xs, ys) in zip(self.adders, inputs):
            gadget.populate(tw, xs, ys)
        for col, vals in zip(self.ch_cols + self.maj_cols, ch_vals + maj_vals):
            tw.set_packed_ints(col, vals.astype(np.uint64))
        return np.stack(digest, axis=1)


def sha256_inputs(log_n: int, seed: int) -> np.ndarray:
    """(2^log_n, 16) uint32 message words, drawn row by row as
    `examples/sha256.py` draws them: `random.seed(seed)`, then
    `random.getrandbits(32)` per word."""
    rng = random.Random(seed)
    n = 1 << log_n
    return np.array([rng.getrandbits(32) for _ in range(n * 16)],
                    dtype=np.uint32).reshape(n, 16)


def sha256_system(log_n: int, msgs, device=None):
    """`examples/sha256.py`'s one-table system of 2^log_n compressions of
    the given message words, and its witness on `device` (CUDA unless
    named): returns (core system, witness, digest words per row)."""
    with tracing.span("frontend/compile", root=True):
        m3 = M3ConstraintSystem()
        t = m3.add_table("sha256")
        msg = [t.add_committed(f"m{i}", 0, LOG_U32) for i in range(16)]
        gadget = Sha256.build(t, "sha", msg)
        core, omap = m3.compile([log_n])
    with tracing.span("frontend/witness", root=True):
        wi = WitnessIndex(m3, [log_n])
        tw = wi.table(0)
        msgs = np.asarray(msgs, dtype=np.uint32)
        for i, col in enumerate(msg):
            tw.set_packed_ints(col, msgs[:, i].astype(np.uint64))
        digest = gadget.populate(tw, msgs)
    return core, wi.to_core_witness(core, omap, device), digest
