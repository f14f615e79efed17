"""u32 AND, XOR and OR: the port's counterpart of `examples/bitwise_ops.py`.

Proves 2^log_n_ops rows of the three ops in one M3 table
(`circuits.instance("bitwise_ops", log_n_ops, 0)`: x then y from numpy's
`default_rng(0)`, as the JAX example draws them). The witness is always
checked; no phase split is printed, as the JAX example prints none.

    python -m binius_tpu_torch.examples.bitwise_ops --log-n-ops 8 --log-inv-rate 1 [--cpu]
"""

from __future__ import annotations

import argparse

from .. import circuits
from . import common


def main(argv=None) -> bytes:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-ops", type=int, default=5)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    common.header(f"bitwise_ops: proving {1 << args.log_n_ops} rows of u32 AND/XOR/OR", dev)
    inst = common.trace_gen(lambda: circuits.instance("bitwise_ops", args.log_n_ops, 0, dev),
                            dev)
    common.validate(inst, dev, print_time=False)
    return common.prove_verify(inst, dev, args.log_inv_rate, phases=False)


if __name__ == "__main__":
    main()
