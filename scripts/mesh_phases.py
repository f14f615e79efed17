"""Run chip_smoke.py's grouping and mesh phases alone on the card.

    python3 scripts/mesh_phases.py [--log-rows 22] [--seed 0] [--circuit merkle_tree keccak]

Builds the kernels, prints the card, then for each circuit named (at
chip_smoke.py's size) proves it once with stage 2's same-structure claims
grouped (the CUDA default) and once one prover per claim, the bytes equal,
and runs `chip_smoke.stage2_regimes` on its witness; then proves u32_add at
2^log_rows rows on the card and runs `chip_smoke.mesh_phase` (two ranks,
every mesh proof's bytes those of one device). Each step prints its
seconds. About two minutes of command on an H100.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-rows", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--circuit", nargs="*", default=["merkle_tree", "keccak"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from binius_tpu_torch import circuits, cuda_lib
    from binius_tpu_torch.constraint_system import prove as csp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    grouped = chip_smoke.install_grouped_spy()
    for circuit in args.circuit:
        t0 = time.perf_counter()
        size = circuits.GRID_SIZE.get(circuit) or circuits.CARD_SIZE[circuit]
        core, witness, stmt = circuits.instance(circuit, size, args.seed, dev)
        proofs = {}
        for group in (True, False):
            grouped.clear()
            proofs[group] = csp.prove(core, witness, group_claims=group, **stmt)
            print(f"{circuit} 2^{size} group_claims={group}: {len(proofs[group])} bytes, "
                  f"sha256 {hashlib.sha256(proofs[group]).hexdigest()}, grouped provers' "
                  f"claims {list(grouped)}", flush=True)
        if proofs[True] != proofs[False]:
            raise AssertionError(f"{circuit}: grouped and per-claim proofs differ")
        chip_smoke.stage2_regimes(f"{circuit} 2^{size}", core, witness, grouped)
        del core, witness
        print(f"[phase] {circuit}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    core, witness, stmt = circuits.instance("u32_add", args.log_rows, args.seed, dev)
    proof = csp.prove(core, witness, **stmt)
    del witness
    proven = {"u32_add": (core, stmt, len(proof), hashlib.sha256(proof).hexdigest())}
    torch.cuda.empty_cache()
    launches = chip_smoke.mesh_phase(args.log_rows, args.seed, dev, proven)
    print(f"mesh launches: {launches}", flush=True)
    print(f"[phase] mesh: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
