"""B32 multiplication: the port's counterpart of `examples/b32_mul.py`.

Proves 2^log_n_muls products a * b = c over B32, a hand-built system of
three committed columns and one constraint A * B + C
(`circuits.instance("b32_mul", log_n_muls, seed)`: a then b from numpy's
`default_rng(seed)`, c computed on the device; the first run is seed 0, run
i of --repeat seed i). The witness is checked at 2^16 products or fewer, or
with --validate.

    python -m binius_tpu_torch.examples.b32_mul --log-n-muls 8 --log-inv-rate 1 [--cpu]
"""

from __future__ import annotations

import argparse

from .. import circuits
from . import common


def main(argv=None) -> bytes:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-muls", type=int, default=8)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--validate", action="store_true", help=common.VALIDATE_HELP)
    ap.add_argument("--repeat", type=int, default=1, help=common.REPEAT_HELP)
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    n = 1 << args.log_n_muls
    common.header(f"b32_mul: proving {n} B32 multiplications", dev)

    def build(seed):
        return circuits.instance("b32_mul", args.log_n_muls, seed, dev)

    inst = common.trace_gen(lambda: build(0), dev)
    if args.validate or n <= 1 << 16:
        common.validate(inst, dev, print_time=False)
    return common.prove_verify(inst, dev, args.log_inv_rate, build, args.repeat)


if __name__ == "__main__":
    main()
