#!/usr/bin/env python3
"""Where the Vision Mark-32 tree's time goes on the card.

Builds the Vision tree over the u32_add commit's codeword (2^log_rows rows,
--seed; `fri.leaf_blobs` at the commit's log_coset, as `chip_smoke.py`'s
Vision phase does) and prints: the leaves' and each level's time (host
clock, each ending in `torch.cuda.synchronize`), one `permute_batch` at
several batch sizes, the torch ops one `tower.invert(5)` and one
permutation issue (each op one kernel launch but for views), and one
warm tree build under `torch.profiler` (torch ops by host time and by
device time, with call counts).

    python3 scripts/profile_vision.py [--log-rows 22] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-rows", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_vision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from binius_tpu_torch import cuda_lib
    from binius_tpu_torch.fields import tower
    from binius_tpu_torch.hash import vision
    from binius_tpu_torch.merkle.tree import MerkleTree, vision_scheme
    from binius_tpu_torch.protocols import fri, piop
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_lib.lib()
    dev = torch.device("cuda")
    inst = chip_smoke.instance(args.log_rows, args.seed, dev)
    params = inst["params"]
    cw = piop.commit(params, inst["meta"], inst["packed"])[0]
    blobs = fri.leaf_blobs(cw.cpu().numpy().view(np.uint32), params.log_coset)
    scheme = vision_scheme()
    MerkleTree.build(scheme.hash_leaves(blobs), scheme)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cur = scheme.hash_leaves(blobs)
    torch.cuda.synchronize()
    print(f"leaves: {blobs.shape[0]} of {blobs.shape[1]} B, "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    while cur.shape[0] > 1:
        t0 = time.perf_counter()
        cur = scheme.compress_pairs(cur.reshape(-1, 64))
        torch.cuda.synchronize()
        print(f"level of {cur.shape[0]} nodes: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for n in (1, 64, 1 << 12, 1 << 16, 1 << 18, blobs.shape[0]):
        st = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 24), dtype=torch.int32, device=dev,
                           generator=gen)
        vision.permute_batch(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            vision.permute_batch(st)
        torch.cuda.synchronize()
        print(f"permute_batch of {n} states: {(time.perf_counter() - t0) / 3 * 1e3:.2f} ms")

    def n_ops(fn) -> int:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            fn()
        return sum(e.name.startswith("aten::") and e.cpu_parent is None for e in p.events())

    st = torch.randint(-2 ** 31, 2 ** 31 - 1, (64, 24), dtype=torch.int32, device=dev,
                       generator=gen)
    print(f"torch ops: tower.invert(5) {n_ops(lambda: tower.invert(5, st))}, one permutation "
          f"{n_ops(lambda: vision.permute_batch(st))}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        MerkleTree.build(scheme.hash_leaves(blobs), scheme)
        torch.cuda.synchronize()
    table = prof.key_averages()
    print(table.table(sort_by="self_cpu_time_total", row_limit=15))
    print(table.table(sort_by="self_cuda_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
