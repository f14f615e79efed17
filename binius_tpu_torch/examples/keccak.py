"""Keccak-f[1600] permutations: the port's counterpart of `examples/keccak.py`.

Proves 2^log_n_permutations permutations in one M3 table
(`circuits.instance("keccak", log_n_permutations, 0)`: 25 lanes per row,
each `getrandbits(64)` after seeding Python's generator with 0, as the JAX
example draws them). --skip-validate, --skip-prove and --skip-verify leave
out their steps, as the JAX example's do; no phase split is printed, as
it prints none.

    python -m binius_tpu_torch.examples.keccak --log-n-permutations 1 [--cpu]
"""

from __future__ import annotations

import argparse

from .. import circuits
from . import common


def main(argv=None) -> bytes | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-permutations", type=int, default=1)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--skip-prove", action="store_true",
                    help="only build and check the witness")
    ap.add_argument("--skip-validate", action="store_true",
                    help="skip the witness check (timing runs)")
    ap.add_argument("--skip-verify", action="store_true",
                    help="skip the proof's verification (timing runs)")
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    log_n = args.log_n_permutations
    common.header(f"keccak: proving {1 << log_n} Keccak-f[1600] permutations", dev)
    inst = common.trace_gen(lambda: circuits.instance("keccak", log_n, 0, dev), dev)
    if not args.skip_validate:
        common.validate(inst, dev)
    if args.skip_prove:
        return None
    return common.prove_verify(inst, dev, args.log_inv_rate, phases=False,
                               verify=not args.skip_verify)


if __name__ == "__main__":
    main()
