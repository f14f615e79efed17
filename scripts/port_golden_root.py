"""Print the JAX package's commit root for the seeded u32_add witness.

The H100 port's `chip_smoke.py` holds this root as its golden constant
(`GOLDEN_ROOT_16`): its kernel path must reproduce it byte for byte. The
witness is the one `binius_tpu_torch.m3.gadgets.arith.u32_add_columns`
draws, rebuilt here with numpy so that this script runs on the JAX package
alone (on the CPU):

    python scripts/port_golden_root.py [--log-rows 16] [--seed 0]
"""

from __future__ import annotations

import argparse
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
    from binius_tpu.protocols import piop

    rng = np.random.default_rng(args.seed)
    n = 1 << args.log_rows
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    full = x + y
    cin = full ^ x ^ y
    cout = ((cin >> np.uint64(1)) & np.uint64(0x7FFFFFFF)) | ((full >> np.uint64(32)) << np.uint64(31))
    cols = [c.astype(np.uint32) for c in (x, y, full & np.uint64(0xFFFFFFFF), cout)]
    n_vars = args.log_rows + 5 - 7      # packed B128 variables per column
    meta = piop.CommitMeta((0,) * n_vars + (len(cols),))
    params = piop.make_commit_params(meta, 100, 1)
    mles = [(jnp.asarray(c.reshape(-1, 4)), n_vars) for c in cols]
    print(piop.commit(params, meta, mles)[1].root.hex())


if __name__ == "__main__":
    main()
