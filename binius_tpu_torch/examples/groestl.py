"""Grøstl-256 P permutations: the port's counterpart of `examples/groestl.py`.

Proves 2^log_n_permutations P permutations in one M3 table
(`m3.gadgets.groestl.groestl_system`). The states are drawn as the JAX
example draws them: 64 bytes per state, row-major, each `getrandbits(8)`
of one generator seeded with 0, run after run of --repeat continuing it (the
first run's states are `circuits.instance("groestl", log_n_permutations,
0)`'s). The witness is checked below 2^14 permutations, or with
--validate; --skip-prove stops there.

    python -m binius_tpu_torch.examples.groestl --log-n-permutations 3 [--cpu]
"""

from __future__ import annotations

import argparse
import random

import numpy as np

from ..m3.gadgets import groestl
from . import common


def main(argv=None) -> bytes | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-permutations", type=int, default=3)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--skip-prove", action="store_true")
    ap.add_argument("--validate", action="store_true", help=common.VALIDATE_HELP)
    ap.add_argument("--repeat", type=int, default=1, help=common.REPEAT_HELP)
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    log_n = args.log_n_permutations
    n = 1 << log_n
    common.header(f"groestl: proving {n} Grøstl P permutations", dev)
    rng = random.Random(0)

    def build(_run=0):
        states = np.array([rng.getrandbits(8) for _ in range(n * 64)],
                          dtype=np.uint8).reshape(n, 8, 8)
        return (*groestl.groestl_system(log_n, states, dev)[:2], {})

    inst = common.trace_gen(build, dev)
    if args.validate or n < 1 << 14:
        common.validate(inst, dev)
    if args.skip_prove:
        return None
    return common.prove_verify(inst, dev, args.log_inv_rate, build, args.repeat)


if __name__ == "__main__":
    main()
