"""The readings that a cell's limits are set from, on the card, in one process.

    python3 port_bench/control.py --workload <cell> --seconds <s> \
        --sound <seed,seed,...> --control <seed,seed,...>

Each seed is one run of the cell's window at its own size and load
(`run.run_cell`, the window `--seconds` long), then the reference's check of
a sample of its proofs. Sound runs are the program as it is. Control runs
prove below the configuration's guarantee: 20 security bits fewer than the
configuration states, the step that would tempt a faster prover (fewer FRI
queries); the reference holds every proof to the stated security, so each
number compared reads 0 in a sound run and the control has to fail one.
One JSON line per run, then the largest sound and the least control reading
of each number. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", default="")
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        bench_run.log("needs a CUDA device")
        return 3
    dev = torch.device("cuda:0")
    readings = {"sound": [], "control": []}
    for kind, seeds in (("sound", args.sound), ("control", args.control)):
        for seed in (int(s) for s in seeds.split(",") if s):
            cell = bench_run.Cell.find(bench_run.load_bench(), args.workload)
            faults = ("low_security",) if kind == "control" else ()
            result, jobs = bench_run.run_cell(cell, seed, args.seconds, False, dev, faults)
            checks = {k: c["value"] for k, c in result["checks"].items()}
            readings[kind].append(checks)
            print(json.dumps({"kind": kind, "seed": seed, "correct": result["correct"],
                              "jobs": len(jobs), "checks": checks,
                              "proof_s": result["metrics"].get("proof_s", {}).get("value")}),
                  flush=True)
    names = sorted({k for r in readings["sound"] + readings["control"] for k in r})
    summary = {n: {"sound_max": max((r[n] for r in readings["sound"]), default=None),
                   "control_min": min((r[n] for r in readings["control"]), default=None)}
               for n in names}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
