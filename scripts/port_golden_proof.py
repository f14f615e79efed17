"""Print the JAX package's u32_add proof digest for a seeded instance.

The H100 port's `chip_smoke.py` holds this digest as its golden constant
(`GOLDEN_PROOF_16`): the port's `constraint_system.prove`, on its kernel
path and on its plain path, must reproduce the proof byte for byte. The
instance is one u32_add table of 2^log_rows rows built with the JAX
package's M3 front end (`U32Add.build`, `WitnessIndex`), its inputs x and
y the 2^log_rows u32 pairs that
`binius_tpu_torch.m3.gadgets.arith.u32_add_rows(log_rows, seed)` draws
(numpy's `default_rng(seed)`: x, then y), rebuilt here with numpy so that
this script runs on the JAX package alone, on the CPU; the proof is
`constraint_system.prove.prove(core, witness, log_inv_rate=1)`, checked
with the JAX verifier:

    python scripts/port_golden_proof.py [--log-rows 16] [--seed 0]

It prints the proof's length and sha256 (a few minutes at 2^16 rows on a
CPU, most of it compiling).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-rows", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from binius_tpu.constraint_system import prove as csp
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex
    from binius_tpu.m3.gadgets import arith

    rng = np.random.default_rng(args.seed)
    n = 1 << args.log_rows
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    m3 = M3ConstraintSystem()
    t = m3.add_table("u32add")
    xin = t.add_committed("xin", 0, arith.LOG_U32)
    yin = t.add_committed("yin", 0, arith.LOG_U32)
    adder = arith.U32Add.build(t, "add", xin, yin)
    core, omap = m3.compile([args.log_rows])
    wi = WitnessIndex(m3, [args.log_rows])
    tw = wi.table(0)
    tw.set_packed_ints(xin, x)
    tw.set_packed_ints(yin, y)
    adder.populate(tw, x, y)
    proof = csp.prove(core, wi.to_core_witness(core, omap), log_inv_rate=1)
    csp.verify(core, proof, log_inv_rate=1)
    print(len(proof), hashlib.sha256(proof).hexdigest())


if __name__ == "__main__":
    main()
