#!/usr/bin/env python3
"""Run `chip_smoke.py`'s Vision-tree and AES/POLYVAL phases alone on the card.

The two phases (5b and 5c of `chip_smoke.py`, executed from its own
source) after what they need from the earlier ones: the kernels' build,
the u32_add instance at 2^22 rows and its opening, and the 2^16-row
instance of the pinned Vision root. About 80 s of command where the whole
script takes over 10 minutes, for iterating on the Vision path.

    python3 scripts/vision_phases.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("vision_phases: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from binius_tpu_torch import cuda_lib
    from binius_tpu_torch.fields import bitslice, bitslice_cuda, tower
    from binius_tpu_torch.protocols import fri, piop

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    inst = cs.instance(22, 0, dev)
    params = inst["params"]
    cs.open_commitment(inst)
    proof = cs.open_commitment(inst)
    n_leaves = (1 << (params.log_batch_size + params.log_code_len)) >> params.log_coset
    src = open(os.path.join(root, "chip_smoke.py")).read()
    end = '    phases.done("aes and polyval")\n'
    phase_src = src[src.index("    # 5b. a Vision Mark-32 tree"):src.index(end) + len(end)]
    ns = dict(vars(cs))
    ns.update(inst=inst, params=params, proof=proof, n_leaves=n_leaves,
              blob_len=(1 << params.log_coset) * 16, g_inst=cs.instance(16, 0, dev),
              args=type("Args", (), {"seed": 0})(), dev=dev,
              gen=torch.Generator(device=dev).manual_seed(0), cuda_lib=cuda_lib,
              bitslice=bitslice, bitslice_cuda=bitslice_cuda, tower=tower, fri=fri, piop=piop,
              phases=cs.Phases())
    exec(compile(textwrap.dedent(phase_src), "chip_smoke phases 5b-5c", "exec"), ns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
