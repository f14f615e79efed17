"""Profile one warm opening of the u32_add commitment on the card.

    python3 scripts/profile_opening.py [--log-rows 22] [--seed 0]

Builds the instance of `chip_smoke.py` (the u32_add witness, one claim per
column at the point drawn after it), runs one opening as a warm-up, then
one under `torch.profiler` (CPU and CUDA activities). Prints the card
(nvidia-smi name and power limit), the opening's wall time (host clock
around work that ends in `torch.cuda.synchronize()`), the device time by
kernel name (sum, calls, mean), the sum over all device kernels and the
device's idle share of the wall time (one stream, so kernels do not
overlap), and the port's launch counts for the same opening.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-rows", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_opening: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from binius_tpu_torch import cuda_lib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    inst = chip_smoke.instance(args.log_rows, args.seed, torch.device("cuda"))
    chip_smoke.open_commitment(inst)   # warm-up: build, plans, tables
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.open_commitment(inst)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(cuda_lib.launches)

    # the device's own events (kernels, copies, fills), not the host ops
    # that launched them
    kernels = [(ev.self_device_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    print(f"opening 2^{args.log_rows} rows under the profiler: wall {wall_ms:.3f} ms, device "
          f"kernels {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}")
    print(f"launches (port counters): {launches}")
    print(f"{'device ms':>10} {'calls':>6} {'mean us':>9}  kernel")
    for ms, count, key in kernels[:args.top]:
        print(f"{ms:10.3f} {count:6d} {ms / count * 1e3:9.2f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
