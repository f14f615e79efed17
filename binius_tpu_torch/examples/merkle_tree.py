"""Merkle-tree inclusion proofs: the port's counterpart of
`examples/merkle_tree.py`.

Proves the paths of --n-opened leaves of a Grøstl-256 tree of
2^log_n_leaves leaves (`m3.gadgets.merkle_tree.merkle_system`: the
increment lookup, three nodes tables and the roots table, the opened
leaves and the root as boundaries, the table sizes as the proof's first
message). The leaves' bytes and then the opened indices are drawn as the
JAX example draws them, after seeding Python's generator with 0
(`merkle_tree.merkle_inputs`; `circuits.instance("merkle_tree", size, 0)`
is the same instance where --n-opened is `circuits.merkle_opened(size)`).
The witness is always checked.

    python -m binius_tpu_torch.examples.merkle_tree --log-n-leaves 4 --n-opened 3 [--cpu]
"""

from __future__ import annotations

import argparse

from ..m3.gadgets import merkle_tree
from . import common


def main(argv=None) -> bytes:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n-leaves", type=int, default=4)
    ap.add_argument("--n-opened", type=int, default=3)
    ap.add_argument("--log-inv-rate", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help=common.CPU_HELP)
    args = ap.parse_args(argv)
    dev = common.device(args.cpu)
    common.header(f"merkle_tree: proving {args.n_opened} inclusions in a "
                  f"{1 << args.log_n_leaves}-leaf tree", dev)

    def build():
        leaves, opened = merkle_tree.merkle_inputs(args.log_n_leaves, args.n_opened, 0)
        return merkle_tree.merkle_system(leaves, opened, dev)[:3]

    inst = common.trace_gen(build, dev)
    common.validate(inst, dev)
    return common.prove_verify(inst, dev, args.log_inv_rate, phases=False)


if __name__ == "__main__":
    main()
