"""The port's native host library: tower scalar algebra (`b128.c`) and the
Grøstl-256 T-table core (`groestl.c`), loaded with ctypes.

The card carries the prover's bulk work; this library carries the host's:
scalar products, squares, inverses and powers (`fields/scalar.py`),
B128 batch products (`protocols/ring_switch.py`), barycentric weights and
Lagrange evaluations (`math/univariate.py`), and Grøstl-256 for the
transcript and host Merkle hashing (`hash/groestl.py`). The reference runs
the same work in native Rust. Each caller keeps its pure-Python version
beside it as the plain version the C is tested against.

On first call `get_lib` compiles both sources with the system C compiler
(`$CC`, else `cc`; `-O2 -shared -fPIC`) into `binius_tpu_torch/build/`,
named by a hash of the compiler, flags and sources, through a temporary
name and `os.replace`, so that processes building at once each load a
whole library. Importing this module builds nothing. A missing compiler
or a failed build raises with the compiler's output: no caller falls back
to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent / "build"
SOURCES = ("b128.c", "groestl.c")
CFLAGS = ("-O2", "-shared", "-fPIC")

# every pointer passes as c_void_p: a numpy array's `.ctypes.data`, a
# ctypes array or `bytes` (read only)
_u64, _ptr, _sz = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t
_SIGNATURES = {
    "tower_init": (),
    "tower_mul": (ctypes.c_int, _u64, _u64, _u64, _u64, _ptr),
    "tower_square": (ctypes.c_int, _u64, _u64, _ptr),
    "tower_invert": (ctypes.c_int, _u64, _u64, _ptr),
    "tower_pow": (ctypes.c_int, _u64, _u64, _u64, _ptr),
    "tower_mul_batch": (ctypes.c_int, _ptr, _ptr, _ptr, _sz),
    "tower_barycentric_weights": (_ptr, _sz, _ptr),
    "tower_lagrange_evals": (_ptr, _ptr, _sz, _u64, _u64, _ptr, _ptr),
    "groestl_init": (_ptr, _ptr, _ptr, _ptr, _ptr),
    "groestl_permute": (_ptr, ctypes.c_int),
    "groestl_compress": (_ptr, _ptr),
    "groestl_compress_seq": (_ptr, _ptr, _sz),
    "groestl_output_transform": (_ptr, _ptr),
    "groestl_digest": (_ptr, _ptr, _sz, _ptr),
    "groestl_digest_batch": (_ptr, _ptr, _sz, _sz, _ptr),
    "groestl_compress_pairs": (_ptr, _sz, _ptr),
}

_lib = None
_lock = threading.Lock()


def compiler() -> str:
    return os.environ.get("CC") or "cc"


def build() -> Path:
    """Compile the sources into a shared library and return its path; a
    library built from the same compiler, flags and sources is reused."""
    cc = compiler()
    digest = hashlib.sha256(" ".join((cc, *CFLAGS)).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((HERE / name).read_bytes())
    so = BUILD / f"libbinius_native_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f".{so.name}.{os.getpid()}.{threading.get_ident()}"
    cmd = [cc, *CFLAGS, "-o", str(tmp), *(str(HERE / name) for name in SOURCES)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native: cannot run the C compiler {cc!r} ({e}); set CC or "
                           f"put cc on PATH") from e
    if out.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native: {' '.join(cmd)} failed (exit {out.returncode}):\n"
                           f"{out.stderr}{out.stdout}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on the first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, args in _SIGNATURES.items():
                    getattr(lib, name).argtypes = args
                lib.tower_init()
                _lib = lib
    return _lib

