"""Prove every small golden instance on a mesh of ranks on the CPU and hold
each rank's proof to the one-process proof.

    python scripts/mesh_sweep.py [--world 2] [--min-shard-elems 1] [--group-claims 1]

The instances are `chip_smoke.GOLDEN_CIRCUITS`'s (each at its pinned size,
seed 0) and u32_add at 2^3 to 2^11 rows; the ranks run over gloo
(`parallel.distributed.run_ranks`), every column sharded that divides
(`--min-shard-elems 1`) so that each sharding rule of the zerocheck and the
commit meets small and odd shapes. Prints one line per instance (OK or
MISMATCH) and the ranks' seconds. About two minutes at world 2 or 4 on a
few CPU cores.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _cases() -> list:
    import chip_smoke
    return ([("u32_add", s) for s in (3, 4, 5, 6, 7, 9, 11)]
            + [(c, size) for c, (size, _, _) in chip_smoke.GOLDEN_CIRCUITS.items()])


def _prove_all(cases: list, min_shard_elems: int | None, group_claims: bool | None,
               mesh: bool) -> list:
    from binius_tpu_torch import circuits
    from binius_tpu_torch.constraint_system import prove as csp
    from binius_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    out = []
    for circuit, size in cases:
        core, witness, stmt = circuits.instance(circuit, size, 0, "cpu")
        kw = dict(mesh=mesh_mod.make_mesh(), min_shard_elems=min_shard_elems,
                  group_claims=group_claims) if mesh else dict(device="cpu")
        out.append(hashlib.sha256(csp.prove(core, witness, **kw, **stmt)).hexdigest())
    return out


def _rank(cases: list, min_shard_elems: int | None, group_claims: bool | None) -> list:
    return _prove_all(cases, min_shard_elems, group_claims, True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--min-shard-elems", type=int, default=1)
    ap.add_argument("--group-claims", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    from binius_tpu_torch.parallel import distributed

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mesh_sweep

    cases = _cases()
    want = _prove_all(cases, None, None, False)
    t0 = time.perf_counter()
    ranks = distributed.run_ranks(mesh_sweep._rank, args.world,
                                  (cases, args.min_shard_elems, bool(args.group_claims)),
                                  device="cpu", timeout=3600)
    bad = 0
    for i, (circuit, size) in enumerate(cases):
        ok = all(r[i] == want[i] for r in ranks)
        bad += not ok
        print(f"world {args.world} {circuit} 2^{size}: {'OK' if ok else 'MISMATCH'}", flush=True)
    print(f"ranks: {time.perf_counter() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
