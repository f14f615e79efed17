"""Build and load the port's Hopper kernels (`csrc/*.cu`).

On first use every source is compiled by its own `nvcc` process for
`sm_90a`, all started together, and the objects are linked into one shared
library under `binius_tpu_torch/build/`, named by a hash of the sources and
flags so that an edit rebuilds. The library has a plain C interface and is
loaded with ctypes; each entry launches on the stream it is given and
returns `cudaGetLastError()`.

`launches` counts, per kernel, the launches the wrappers made; a wrapper
adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("k1_tower_mul", "k2_transpose32", "k3_ntt_local", "k4_ntt_cross",
           "k5_groestl_leaf", "k6_groestl_pairs")
launches = dict.fromkeys(KERNELS, 0)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "k1_tower_mul": (_P, _P, _P, _I, _L, _I, _I, _I, _P),
    "k2_transpose32": (_P, _P, _I, _L, _I, _P),
    "k3_ntt_local": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "k4_ntt_cross": (_P, _P, _I, _I, _I, _I, _I, _P),
    "k5_groestl_leaf": (_P, _I, _I, _P, _P, _I, _P),
    "k6_groestl_pairs": (_P, _I, _P, _P, _I, _P),
}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile csrc/*.cu (one nvcc each, in parallel) and link; returns the
    library path. A library already built from the same sources and headers
    (csrc/*.cuh) is reused.
    The compiler's report (registers, spills) is kept in build/ptxas.log."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD / f"libbinius_torch_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = BUILD / f"{src.stem}_{tag}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode:
            failed.append(src.name)
    (BUILD / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD / f".{lib_path.name}.{os.getpid()}"
    subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                    *(str(o) for _, o, _ in procs)], check=True)
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def call(name: str, *args) -> None:
    """Launch kernel `name` on the current stream; raise on a launch error."""
    err = getattr(lib(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    launches[name] += 1


def check(t: torch.Tensor, name: str, ndim: int | None = None, align: int = 8) -> None:
    """The wrappers' argument check: a contiguous CUDA tensor of int32
    words, aligned to `align` bytes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected torch.int32, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: expected a contiguous, {align}-byte aligned tensor")
