"""K3's and K4's B32-twiddle kernels against another tree's, in SASS.

    python3 scripts/ntt_sass.py DIR

DIR is a checkout of another commit (e.g. `git archive` of it unpacked
into a directory that .gitignore lists). Compiles DIR's and this tree's
`binius_tpu_torch/csrc/ntt.cu` with `cuda_lib.NVCC_FLAGS` (needs nvcc and
cuobjdump, no card) and compares, instruction for instruction with
addresses and encodings stripped, this tree's `ntt_local_kernel<5, INV>`
and `ntt_cross_kernel<5, INV>` with DIR's kernel of the same kind and
direction (a template on the direction alone, or on the level too).
Prints each kernel's instruction count and whether the two are the same;
where they differ, both listings go to chiprun_out/. Exits 1 on a
difference.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a mangled K3 / K4 name: kind, the level template argument (absent in a
# tree whose kernels are templates on the direction alone), the direction
KERNEL = re.compile(r"ntt_(local|cross)_kernelI(?:Li(\d)E)?Lb([01])E")


def b32_kernels_sass(nvcc: str, flags: tuple, src: str, out_dir: str) -> dict:
    """(kind, inverse) -> SASS instruction lines of the kernel at level 5
    (or of the kernel of that direction where it has no level)."""
    obj = os.path.join(out_dir, "ntt.o")
    subprocess.run([nvcc, *flags, "-c", src, "-o", obj], check=True, capture_output=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            k = KERNEL.search(m.group(1))
            cur = (k.group(1), k.group(3) == "1") if k and k.group(2) in (None, "5") else None
            if cur:
                out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if cur and m:
            out[cur].append(m.group(1))
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    against = sys.argv[1]
    sys.path.insert(0, ROOT)
    from binius_tpu_torch import cuda_lib

    nvcc = cuda_lib._nvcc()
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        ours = b32_kernels_sass(nvcc, cuda_lib.NVCC_FLAGS, str(cuda_lib.CSRC / "ntt.cu"), a)
        theirs = b32_kernels_sass(nvcc, cuda_lib.NVCC_FLAGS, os.path.join(
            against, "binius_tpu_torch", "csrc", "ntt.cu"), b)
    if sorted(ours) != sorted(theirs) or len(ours) != 4:
        raise AssertionError(f"kernels {sorted(ours)} here, {sorted(theirs)} there")
    n_differ = 0
    for key in sorted(ours):
        same = ours[key] == theirs[key]
        diff = [i for i, (x, y) in enumerate(zip(ours[key], theirs[key])) if x != y]
        print(f"sass ntt_{key[0]}_kernel {'inverse' if key[1] else 'forward'} at B32 "
              f"twiddles: {len(ours[key])} instructions here, {len(theirs[key])} in {against}: "
              + ("identical" if same else f"{len(diff)} differ, the first at {diff[:1]}"),
              flush=True)
        if not same:  # both listings, for a diff
            n_differ += 1
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            for tag, lines in (("here", ours[key]), ("there", theirs[key])):
                with open(os.path.join(ROOT, "chiprun_out", f"sass_ntt_{key[0]}_"
                                       f"{int(key[1])}_{tag}.txt"), "w") as f:
                    f.write("\n".join(lines) + "\n")
    return 1 if n_differ else 0


if __name__ == "__main__":
    sys.exit(main())
