"""keccak_2e13: one M3 table of 2^log_size Keccak-f[1600] permutations.

The statement: 25 uniform 64-bit lanes per permutation. The program's front
end is `keccak.keccak_system` (all 24 rounds in a row). The reference's
part: the same system written out oracle by oracle in the table's order, and
the committed columns (the inputs and every round's output) worked out by
the permutation as FIPS 202 defines it.
"""

from __future__ import annotations

import numpy as np

from reference.verifier import Builder, Expr, System, constraint_set

LOG_WIDTH = 6   # one lane per row: 64 bits, the low variables
ROUNDS = 24
# rotation offsets r[x][y] and round constants of FIPS 202
RHO = ((0, 36, 3, 41, 18), (1, 44, 10, 45, 2), (62, 6, 43, 15, 61), (28, 55, 25, 21, 56),
       (27, 20, 39, 8, 14))


def _round_constants() -> list[int]:
    """RC[i] from the degree-8 LFSR of FIPS 202, algorithm 5."""
    r = 1
    bits = []
    for _ in range(7 * ROUNDS):
        bits.append(r & 1)
        r <<= 1
        if r & 0x100:
            r ^= 0x171
    out = []
    for i in range(ROUNDS):
        rc = 0
        for j in range(7):
            rc |= bits[7 * i + j] << ((1 << j) - 1)
        out.append(rc)
    return out


RC = _round_constants()


def draw(log_size: int, seed: int, index: int) -> dict:
    rng = np.random.default_rng([seed % (1 << 64), index])
    return {"lanes": rng.integers(0, 1 << 64, (1 << log_size, 25), dtype=np.uint64,
                                  endpoint=False)}


def build(stmt: dict, log_size: int, device):
    """The program's front end: (system, witness) on `device`."""
    from binius_tpu_torch.m3.gadgets import keccak
    return keccak.keccak_system(log_size, stmt["lanes"], device)[:2]


def reference_system(log_size: int, digest: bytes) -> System:
    n_vars = log_size + LOG_WIDTH
    b = Builder()
    v = Expr.var
    a = [b.committed(n_vars) for _ in range(25)]          # lane x + 5y
    constraints = []
    for r in range(ROUNDS):
        c = [b.linear_combination([a[x + 5 * y] for y in range(5)], [1] * 5) for x in range(5)]
        rot_c = [b.shifted(c[x], 1, LOG_WIDTH, "circular_left") for x in range(5)]
        t = [b.linear_combination([a[x + 5 * y], c[(x + 4) % 5], rot_c[(x + 1) % 5]], [1] * 3)
             for y in range(5) for x in range(5)]
        lanes = [0] * 25
        for x in range(5):
            for y in range(5):
                src = t[x + 5 * y]
                lanes[y + 5 * ((2 * x + 3 * y) % 5)] = (
                    b.shifted(src, RHO[x][y], LOG_WIDTH, "circular_left") if RHO[x][y] else src)
        pattern = b.transparent([(RC[r] >> z) & 1 for z in range(64)], 0)
        rc = b.repeating(pattern, log_size)
        nxt = []
        for y in range(5):
            for x in range(5):
                out = b.committed(n_vars)
                nxt.append(out)
                cols = [out, lanes[x + 5 * y], lanes[(x + 1) % 5 + 5 * y],
                        lanes[(x + 2) % 5 + 5 * y]]
                # chi (and iota on lane 0): A' + B0 + (1 + B1) B2 (+ RC) = 0
                expr = v(0) + v(1) + (Expr.const(1) + v(2)) * v(3)
                if x == 0 and y == 0:
                    cols.append(rc)
                    expr = expr + v(4)
                constraints.append((cols, expr))
        a = nxt
    return System(digest, tuple(b.oracles), (constraint_set(n_vars, constraints),))


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    n %= 64
    return v if n == 0 else (v << np.uint64(n)) | (v >> np.uint64(64 - n))


def reference_columns(stmt: dict) -> tuple[dict, int]:
    """Oracle id -> one lane per row: the inputs, then each round's output,
    at the ids `reference_system` gives them (86 oracles a round, the
    outputs the last 25)."""
    a = [stmt["lanes"][:, i].astype(np.uint64) for i in range(25)]
    cols = {i: a[i] for i in range(25)}
    for r in range(ROUNDS):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y] ^ d[x], RHO[x][y])
        a = [b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y])
             for y in range(5) for x in range(5)]
        a[0] = a[0] ^ np.uint64(RC[r])
        base = 25 + 86 * r + 61
        cols.update({base + i: a[i] for i in range(25)})
    return cols, LOG_WIDTH
