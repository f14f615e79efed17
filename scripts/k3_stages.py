"""Where K3's time goes on the card: the fused local NTT stages at the
2^22-row commit's shape, timed at 1, 2, 4, 8 and all of their stages.

    python3 scripts/k3_stages.py [--log-rows 22] [--reps 7]

Prints the card (nvidia-smi name and power limit), the ptxas report of
`ntt.cu` (registers, spills per function), the SASS counts of the NTT
kernels (`chip_smoke.sass_counts`), then K3's time with CUDA events
(median of --reps) on random planes [128, W] for the last s stages of
the commit's plan, run through `bitsliced_ntt.ntt_local` with a plan
whose `n_local` is s, each checked bit-equal to the plain version first.
The time at one stage less the per-stage slope is
what the tile's copy in and out costs; the slope is one stage's network.
Then K4's time on the same planes at the commit's cross stages, which run
the same network.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import re
import subprocess
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-rows", type=int, default=22)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from binius_tpu_torch import cuda_lib
    from binius_tpu_torch.ntt import bitsliced_ntt as bn
    from binius_tpu_torch.protocols import fri, piop

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    so = cuda_lib.build()
    cuda_lib.lib()
    log = (cuda_lib.BUILD / "ptxas.log").read_text().split("== ")
    for part in log:
        if part.startswith("ntt.cu"):
            for line in part.splitlines():
                if "registers" in line or "spill" in line or "Function properties" in line:
                    print("  ptxas:", line.strip())
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    for fn, c in chip_smoke.sass_counts(cuobjdump, so, r"ntt_\w*_kernel").items():
        print(f"  sass: {fn}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    # the opcode mix of each NTT kernel, most frequent first
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split()[0]
        if re.search(r"ntt_\w*_kernel", name):
            ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)", block))
            print(f"  opcodes: {name}: " + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)))

    dev = torch.device("cuda")
    # chip_smoke.instance's commitment: four u32 columns of B1, 2^(log_rows + 5)
    # bits each, packed into B128
    meta = piop.CommitMeta((0,) * (args.log_rows - 2) + (4,))
    params = piop.make_commit_params(meta, chip_smoke.SECURITY_BITS, chip_smoke.LOG_INV_RATE)
    shape = (params.log_batch_size, params.log_code_len, 0)
    plan, tw_np = bn._make_plan(params.ntt_domain(), fri.LEVEL, shape, 0, 0,
                                params.log_inv_rate, False)
    tw = bn._dev_tw(plan, tw_np, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << plan.dl, plan.n_words),
                           dtype=torch.int32, device=dev, generator=gen)
    n = len(plan.stages)
    rates = chip_smoke.card_rates()
    print(f"plan: W {plan.n_words} words, {n} stages, {plan.n_local} local, tile {plan.tile}")
    times = {}
    for s in sorted({1, 2, 4, 8, plan.n_local}):
        if s > plan.n_local:
            continue
        sub = dataclasses.replace(plan, n_local=s)
        got = bn.ntt_local(sub, n - s, planes.clone(), tw[n - s:])
        want = planes
        for si in range(n - s, n):
            want = bn._stage_plain(plan, plan.stages[si], want, tw[si])
        if not torch.equal(got, want):
            raise AssertionError(f"K3, last {s} stages: kernel and plain version differ")
        x = planes.clone()
        ms = chip_smoke.cuda_ms(lambda _: bn.ntt_local(sub, n - s, x, tw[n - s:]), args.reps)
        b, by = chip_smoke.bound_ms(2 * planes.numel() * 4 + s * plan.n_words * 4,
                                    chip_smoke.ntt_ops(plan, plan.stages[n - s:]),
                                    rates["gates_per_s"])
        times[s] = ms
        print(f"K3 last {s} stages (d_elems {[st.d_elems for st in plan.stages[n - s:]]}): "
              f"{ms:.4f} ms, bound {b:.4f} ms by {by}", flush=True)
    # K4 on the same planes, the commit's cross stages (it shares K3's network)
    runs = bn._cross_runs(plan)
    x = planes.clone()
    ms = chip_smoke.cuda_ms(lambda _: [bn.ntt_cross(plan, f, k, x, tw[f:f + k]) for f, k in runs],
                            args.reps)
    print(f"K4 the commit's cross runs {runs}: {ms:.4f} ms")
    ks = sorted(times)
    if len(ks) > 1:
        slope = (times[ks[-1]] - times[ks[0]]) / (ks[-1] - ks[0])
        print(f"per stage {slope:.4f} ms; copy in and out {times[ks[0]] - slope:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
