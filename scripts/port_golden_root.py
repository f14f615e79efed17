"""Print the JAX package's commit root for the seeded u32_add witness.

The H100 port's `chip_smoke.py` holds this root as its golden constant
(`GOLDEN_ROOT_16`): its kernel path must reproduce it byte for byte. The
witness is the one `binius_tpu_torch.m3.gadgets.arith.u32_add_columns`
draws, rebuilt here with numpy so that this script runs on the JAX package
alone (on the CPU):

    python scripts/port_golden_root.py [--log-rows 16] [--seed 0] [--scheme vision]

`--scheme vision` prints instead the root of a Vision Mark-32 tree over the
same codeword's leaves (`fri.leaf_blobs` at the commit's `log_coset`:
`vision.digest_many` of the leaves, then `MerkleTree.build(...,
vision_scheme())`), `chip_smoke.GOLDEN_VISION_ROOT_16`, with the seconds
the JAX package took.
"""

from __future__ import annotations

import argparse
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-rows", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheme", choices=("groestl256", "vision"), default="groestl256")
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
    cw, tree, _ = piop.commit(params, meta, mles)
    if args.scheme == "groestl256":
        print(tree.root.hex())
        return
    import time

    from binius_tpu.hash import vision
    from binius_tpu.merkle.tree import MerkleTree, vision_scheme
    from binius_tpu.protocols import fri

    log_coset = params.fold_arities[0] if params.fold_arities else (
        params.log_dim + params.log_batch_size)
    blobs = fri.leaf_blobs(fri.codeword_to_numpy(cw), log_coset)
    t0 = time.perf_counter()
    vtree = MerkleTree.build(vision.digest_many(blobs), vision_scheme())
    print(f"{blobs.shape[0]} leaves of {blobs.shape[1]} bytes: Vision tree in "
          f"{time.perf_counter() - t0:.1f} s (jax {jax.__version__}, CPU)", file=sys.stderr)
    print(vtree.root.hex())


if __name__ == "__main__":
    main()
