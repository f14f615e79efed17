"""u32_add_2e22: one M3 table of 2^log_size u32 additions.

The statement: x and y, uniform u32 words. The program's front end is
`arith.u32_add_system` (the table xin, yin, zout, cout, cin = cout << 1).
The reference's part: the same system written out oracle by oracle, and the
committed columns worked out from x and y by the definition of binary
addition.
"""

from __future__ import annotations

import numpy as np

from reference.verifier import Builder, Expr, System, constraint_set

LOG_WIDTH = 5   # one u32 per row: 32 bits, the low variables


def draw(log_size: int, seed: int, index: int) -> dict:
    rng = np.random.default_rng([seed % (1 << 64), index])
    n = 1 << log_size
    return {"x": rng.integers(0, 1 << 32, n, dtype=np.uint32),
            "y": rng.integers(0, 1 << 32, n, dtype=np.uint32)}


def build(stmt: dict, log_size: int, device):
    """The program's front end: (system, witness) on `device`."""
    from binius_tpu_torch.m3.gadgets import arith
    return arith.u32_add_system(log_size, stmt["x"], stmt["y"], device)


def reference_system(log_size: int, digest: bytes) -> System:
    n_vars = log_size + LOG_WIDTH
    b = Builder()
    x, y, z, cout = (b.committed(n_vars) for _ in range(4))
    cin = b.shifted(cout, 1, LOG_WIDTH, "logical_left")
    v = Expr.var
    cols = [x, y, cin, z, cout]
    # carry: (x + cin)(y + cin) + cin + cout = 0; sum: x + y + cin + z = 0
    carry = (v(0) + v(2)) * (v(1) + v(2)) + v(2) + v(4)
    total = v(0) + v(1) + v(2) + v(3)
    cs = constraint_set(n_vars, [(cols, carry), (cols, total)])
    return System(digest, tuple(b.oracles), (cs,))


def reference_columns(stmt: dict) -> tuple[dict, int]:
    """Oracle id -> one word per row, and the words' log width."""
    x = stmt["x"].astype(np.uint64)
    y = stmt["y"].astype(np.uint64)
    full = x + y                      # 33 bits
    carries_in = full ^ x ^ y         # bit i: the carry into bit i
    cout = carries_in >> np.uint64(1)  # bit i: the carry out of bit i
    z = full & np.uint64(0xFFFFFFFF)
    return {0: x, 1: y, 2: z, 3: cout}, LOG_WIDTH
