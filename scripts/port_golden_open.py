"""Print the JAX package's commitment-opening digest for the seeded u32_add
instance.

The H100 port's `chip_smoke.py` holds this digest as its golden constant
(`GOLDEN_OPEN_16`): its kernel path must reproduce the proof byte for
byte. The proof is the JAX package's FRI-Binius opening of the four
committed columns of a 2^log_rows-row u32_add table at one shared point:
the commitment root as the first message, then `ring_switch.prove` and
`piop.prove`, with `make_commit_params(meta, 100, 1)`. One evaluation claim
per column, at the point of log_rows + 5 B128 coordinates drawn after the
witness from the same generator; each claimed value is the column's
multilinear evaluation there. The witness and point are the ones
`binius_tpu_torch.m3.gadgets.arith.u32_add_instance` draws, rebuilt here
with numpy so that this script runs on the JAX package alone (on the CPU):

    python scripts/port_golden_open.py [--log-rows 16] [--seed 0]

It prints the proof's length and sha256.
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
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from binius_tpu.fields import scalar, tower
    from binius_tpu.math import mle
    from binius_tpu.protocols import piop, ring_switch
    from binius_tpu.transcript.transcript import ProverTranscript

    rng = np.random.default_rng(args.seed)
    n = 1 << args.log_rows
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    full = x + y
    cin = full ^ x ^ y
    cout = (((cin >> np.uint64(1)) & np.uint64(0x7FFFFFFF))
            | ((full >> np.uint64(32)) << np.uint64(31)))
    cols = [c.astype(np.uint32) for c in (x, y, full & np.uint64(0xFFFFFFFF), cout)]
    n_bits = args.log_rows + 5
    point = [int.from_bytes(rng.bytes(16), "little") for _ in range(n_bits)]

    # each column's evaluation: bind the high variables with the suffix's eq
    # expansion, then the 7 low ones (bit positions in a packed element) on
    # the host
    eq = mle.eq_ind_partial_eval(7, tower.from_ints(7, point[7:]))
    _, t = mle.batched_evaluate_partial_high(
        tower.P1, jnp.asarray(np.stack(cols)), n_bits, eq, 7)
    evals = []
    for row in np.asarray(t):
        cur = [int(v[0]) | (int(v[1]) << 32) | (int(v[2]) << 64) | (int(v[3]) << 96) for v in row]
        for z in point[:7]:
            cur = [cur[2 * i] ^ scalar.mul(7, cur[2 * i] ^ cur[2 * i + 1], z)
                   for i in range(len(cur) // 2)]
        evals.append(cur[0])
    claims = [ring_switch.RingSwitchEvalClaim(i, 0, tuple(point), e) for i, e in enumerate(evals)]
    witnesses = [(tower.P1, jnp.asarray(c)) for c in cols]

    packed_vars = n_bits - 7
    meta = piop.CommitMeta((0,) * packed_vars + (len(cols),))
    params = piop.make_commit_params(meta, 100, 1)
    packed = [(jnp.asarray(c.reshape(-1, 4)), packed_vars) for c in cols]
    pt = ProverTranscript()
    cw, tree, _ = piop.commit(params, meta, packed)
    pt.message().write_bytes(tree.root)
    red = ring_switch.prove(claims, witnesses, pt)
    piop.prove(params, meta, cw, tree, packed, red.transparent_mles, red.sumcheck_claims, pt)
    proof = pt.finalize()
    print(len(proof), hashlib.sha256(proof).hexdigest())


if __name__ == "__main__":
    main()
