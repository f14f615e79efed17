"""Print the JAX package's proof digest for a seeded instance of a circuit.

The H100 port's `chip_smoke.py` and its tests hold these digests as golden
constants: the port's `constraint_system.prove`, on its kernel path and on
its plain path, must reproduce each proof byte for byte. Each instance is
built with the JAX package alone, on the CPU, the way the examples build
it, from inputs drawn here with the same generators as the port's
instance helpers:

- `u32_add`: one u32_add table of 2^size rows (`U32Add.build`), x and y
  the 2^size u32 pairs of numpy's `default_rng(seed)` (x, then y), as
  `binius_tpu_torch.m3.gadgets.arith.u32_add_rows` draws them;
- `b32_mul`: `examples/b32_mul.py`'s hand-built system of 2^size B32
  products A*B + C, a and b drawn from `default_rng(seed)` (a, then b), as
  `binius_tpu_torch.m3.gadgets.b32_mul.b32_mul_inputs` draws them;
- `keccak`: `examples/keccak.py`'s table of 2^size Keccak-f[1600]
  permutations, 25 lanes per row from `random.Random(seed).getrandbits(64)`
  (`binius_tpu_torch.m3.gadgets.keccak.keccak_inputs`);
- `groestl`: `examples/groestl.py`'s table of 2^size Grøstl P
  permutations, 64 state bytes per row, row-major, from
  `random.Random(seed).getrandbits(8)`
  (`binius_tpu_torch.m3.gadgets.groestl.groestl_inputs`);
- `u32_mul_gkr`: `examples/u32_mul_gkr.py`'s table of 2^size u32
  products through the GKR exponentiation phase (`MulUU32`), x then y
  from `random.seed(seed)`, each `random.getrandbits(32)`
  (`binius_tpu_torch.m3.gadgets.mul.mul_inputs`);
- `bitwise_ops`: `examples/bitwise_ops.py`'s table of 2^size rows of u32
  AND, XOR and OR, x then y from `default_rng(seed)`
  (`binius_tpu_torch.m3.gadgets.arith.bitwise_rows`).

The proof is `constraint_system.prove.prove(core, witness, log_inv_rate=1)`,
checked with the JAX verifier:

    python scripts/port_golden_proof.py [--circuit u32_add] [--size 16] [--seed 0]

It prints the system digest, then the proof's length and sha256 (minutes
on a CPU, most of it compiling).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import sys

# the size each circuit's golden digest is pinned at
DEFAULT_SIZE = {"u32_add": 16, "b32_mul": 10, "keccak": 1, "groestl": 3,
                "u32_mul_gkr": 7, "bitwise_ops": 5}


def build(circuit: str, size: int, seed: int, variant: str = "P"):
    """(core system, witness) of the JAX package for one instance; the
    port's tests hold the port's builders against it. `variant` picks
    groestl's P or Q permutation (the table `groestl_p` or `groestl_q`)."""
    import numpy as np

    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex

    n = 1 << size
    if circuit == "u32_add":
        from binius_tpu.m3.gadgets import arith
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        y = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        m3 = M3ConstraintSystem()
        t = m3.add_table("u32add")
        xin = t.add_committed("xin", 0, arith.LOG_U32)
        yin = t.add_committed("yin", 0, arith.LOG_U32)
        adder = arith.U32Add.build(t, "add", xin, yin)
        core, omap = m3.compile([size])
        wi = WitnessIndex(m3, [size])
        tw = wi.table(0)
        tw.set_packed_ints(xin, x)
        tw.set_packed_ints(yin, y)
        adder.populate(tw, x, y)
        return core, wi.to_core_witness(core, omap)
    if circuit == "b32_mul":
        from binius_tpu.constraint_system import oracle as om
        from binius_tpu.constraint_system.system import ConstraintSet, ConstraintSystem
        from binius_tpu.fields import tower
        from binius_tpu.math.arith import ArithExpr
        rng = np.random.default_rng(seed)
        a_np = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        b_np = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        oracles = om.OracleSet()
        a_id = oracles.add_committed(size, 5, "a")
        b_id = oracles.add_committed(size, 5, "b")
        c_id = oracles.add_committed(size, 5, "c")
        A, B, C = (ArithExpr.var(i) for i in range(3))
        core = ConstraintSystem(oracles, [ConstraintSet(size, (a_id, b_id, c_id), (A * B + C,))])
        a, b = tower.from_numpy(5, a_np), tower.from_numpy(5, b_np)
        return core, {a_id: (5, a), b_id: (5, b), c_id: (5, tower.mul(5, a, b))}
    if circuit == "bitwise_ops":
        from binius_tpu.m3.gadgets import arith
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        y = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        m3 = M3ConstraintSystem()
        t = m3.add_table("bitwise")
        xin = t.add_committed("xin", 0, arith.LOG_U32)
        yin = t.add_committed("yin", 0, arith.LOG_U32)
        outs = [arith.u32_bitwise_and(t, "and", xin, yin),
                arith.u32_bitwise_xor(t, "xor", xin, yin),
                arith.u32_bitwise_or(t, "or", xin, yin)]
        core, omap = m3.compile([size])
        wi = WitnessIndex(m3, [size])
        tw = wi.table(0)
        for col, vals in zip((xin, yin, *outs), (x, y, x & y, x ^ y, x | y)):
            tw.set_packed_ints(col, vals)
        return core, wi.to_core_witness(core, omap)
    if circuit == "u32_mul_gkr":
        from binius_tpu.m3.gadgets.mul import MulUU32
        random.seed(seed)
        xs = [random.getrandbits(32) for _ in range(n)]
        ys = [random.getrandbits(32) for _ in range(n)]
        m3 = M3ConstraintSystem()
        t = m3.add_table("mul")
        gadget = MulUU32.build(t, "mul")
        core, omap = m3.compile([size])
        wi = WitnessIndex(m3, [size])
        gadget.populate(wi.table(0), xs, ys)
        return core, wi.to_core_witness(core, omap)
    rng = random.Random(seed)
    m3 = M3ConstraintSystem()
    if circuit == "keccak":
        from binius_tpu.m3.gadgets.keccak import KeccakF
        t = m3.add_table("keccak")
        state_in = [t.add_committed(f"in{i}", 0, 6) for i in range(25)]
        gadget = KeccakF.build(t, "kf", state_in)
        rows = [[rng.getrandbits(64) for _ in range(25)] for _ in range(n)]
    elif circuit == "groestl":
        from binius_tpu.m3.gadgets.groestl import Permutation
        t = m3.add_table(f"groestl_{variant.lower()}")
        gadget = Permutation.build(t, "perm", variant)
        rows = [np.array([[rng.getrandbits(8) for _ in range(8)] for _ in range(8)],
                         dtype=np.uint8) for _ in range(n)]
    else:
        raise ValueError(circuit)
    core, omap = m3.compile([size])
    wi = WitnessIndex(m3, [size])
    gadget.populate(wi.table(0), rows)
    return core, wi.to_core_witness(core, omap)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--circuit", choices=sorted(DEFAULT_SIZE), default="u32_add")
    ap.add_argument("--size", "--log-rows", type=int, default=None,
                    help="log2 of the rows, products or permutations")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    size = DEFAULT_SIZE[args.circuit] if args.size is None else args.size

    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from binius_tpu.constraint_system import prove as csp

    core, witness = build(args.circuit, size, args.seed)
    print("digest", core.digest().hex(), flush=True)
    proof = csp.prove(core, witness, log_inv_rate=1)
    csp.verify(core, proof, log_inv_rate=1)
    print(len(proof), hashlib.sha256(proof).hexdigest())


if __name__ == "__main__":
    main()
