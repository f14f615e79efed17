"""Keccak-f[1600] with chi through a lookup channel: the port's counterpart
of `examples/keccak_lookups.py`.

Proves 2^log_n_permutations permutations whose chi step reads the 4-row
bit-AND table through a channel (`KeccakLookedupCS`;
`circuits.instance("keccak_lookups", log_n_permutations, 0)`: 25 lanes per
row, each `getrandbits(64)` after seeding Python's generator with 0, as
the JAX example draws them), through the grand-product phase; the table
sizes are the proof's first message. The witness is always checked;
--skip-prove stops there.

    python -m binius_tpu_torch.examples.keccak_lookups --log-n-permutations 1 [--cpu]
"""

from __future__ import annotations

import argparse

from .. import circuits
from . import common


def main(argv=None) -> bytes | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-permutations", type=int, default=1)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--skip-prove", action="store_true")
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    log_n = args.log_n_permutations
    common.header(f"keccak_lookups: proving {1 << log_n} permutations", dev)
    inst = common.trace_gen(lambda: circuits.instance("keccak_lookups", log_n, 0, dev), dev)
    common.validate(inst, dev)
    if args.skip_prove:
        return None
    return common.prove_verify(inst, dev, args.log_inv_rate, phases=False)


if __name__ == "__main__":
    main()
