"""u32 addition: the port's counterpart of `examples/u32_add.py`.

Proves 2^log_n_adds u32 additions, one M3 table of `U32Add`
(`circuits.instance("u32_add", log_n_adds, seed)`: x then y from numpy's
`default_rng(seed)`; the first run is seed 0, run i of --repeat seed i, as
the JAX example draws them). The witness is checked at 2^16 rows or fewer,
or with --validate.

    python -m binius_tpu_torch.examples.u32_add --log-n-adds 8 --log-inv-rate 1 [--cpu]
"""

from __future__ import annotations

import argparse

from .. import circuits
from . import common


def main(argv=None) -> bytes:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-adds", type=int, default=5)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--validate", action="store_true", help=common.VALIDATE_HELP)
    ap.add_argument("--repeat", type=int, default=1, help=common.REPEAT_HELP)
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    n = 1 << args.log_n_adds
    common.header(f"u32_add: proving {n} u32 additions", dev)

    def build(seed):
        return circuits.instance("u32_add", args.log_n_adds, seed, dev)

    inst = common.trace_gen(lambda: build(0), dev)
    if args.validate or n <= 1 << 16:
        common.validate(inst, dev, print_time=False)
    return common.prove_verify(inst, dev, args.log_inv_rate, build, args.repeat)


if __name__ == "__main__":
    main()
