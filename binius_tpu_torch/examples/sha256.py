"""SHA-256 compressions: the port's counterpart of `examples/sha256.py`.

Proves 2^log_n_compressions compressions of one 16-word block each
(`circuits.instance("sha256", log_n_compressions, 0)`: the message words
row by row, each `getrandbits(32)` after seeding Python's generator with 0,
as the JAX example draws them). --skip-prove stops after checking the
witness.

    python -m binius_tpu_torch.examples.sha256 --log-n-compressions 3 [--cpu]
"""

from __future__ import annotations

import argparse

from .. import circuits
from . import common


def main(argv=None) -> bytes | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-compressions", type=int, default=3)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--skip-prove", action="store_true")
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    common.header(f"sha256: proving {1 << args.log_n_compressions} SHA-256 compressions", dev)
    inst = common.trace_gen(
        lambda: circuits.instance("sha256", args.log_n_compressions, 0, dev), dev)
    common.validate(inst, dev)
    if args.skip_prove:
        return None
    return common.prove_verify(inst, dev, args.log_inv_rate)


if __name__ == "__main__":
    main()
