"""u32 multiplication through the GKR exponentiation phase: the port's
counterpart of `examples/u32_mul_gkr.py`.

Proves 2^log_n_muls full 64-bit u32 products (`MulUU32`;
`circuits.instance("u32_mul_gkr", log_n_muls, 0)`: x then y, each
`getrandbits(32)` after seeding Python's generator with 0, as the JAX
example draws them). The witness is always checked.

    python -m binius_tpu_torch.examples.u32_mul_gkr --log-n-muls 8 --log-inv-rate 1 [--cpu]
"""

from __future__ import annotations

import argparse

from .. import circuits
from . import common


def main(argv=None) -> bytes:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-muls", type=int, default=5)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    common.header(f"u32_mul_gkr: proving {1 << args.log_n_muls} u32 multiplications", dev)
    inst = common.trace_gen(lambda: circuits.instance("u32_mul_gkr", args.log_n_muls, 0, dev),
                            dev)
    common.validate(inst, dev, print_time=False)
    return common.prove_verify(inst, dev, args.log_inv_rate)


if __name__ == "__main__":
    main()
