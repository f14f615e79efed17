"""The port stands alone: binius_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the kernels and the native host library build
only when first called; every module of the JAX package has its counterpart
in the port but those that are TPU- or XLA-specific."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|binius_tpu)(\.|\s|$)", re.MULTILINE)
SOURCES = sorted((ROOT / "binius_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not FORBIDDEN.findall(path.read_text())


def test_package_imports_without_jax_or_nvcc():
    """Import every module in a fresh interpreter where importing jax or
    binius_tpu fails; no module may reach for either, nor build a kernel or
    the native host library."""
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'binius_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "for m in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'binius_tpu')]:\n"
        "    del sys.modules[m]\n"
        "import binius_tpu_torch\n"
        "from binius_tpu_torch import native\n"
        "builds = []\n"
        "build = native.build\n"
        "native.build = lambda: builds.append(1) or build()\n"
        "for info in pkgutil.walk_packages(binius_tpu_torch.__path__, 'binius_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "from binius_tpu_torch import cuda_lib\n"
        "assert cuda_lib._lib is None\n"
        "assert native._lib is None and not builds, builds\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# the JAX package's modules with no counterpart of the same path, each
# TPU- or XLA-specific: the Pallas kernels (their counterparts are
# fields/bitslice_cuda.py for K1/K2 and hash/groestl_cuda.py for K5/K6),
# the MXU bit-matrix multiply (fields/fastmul.py), the bitsliced XLA Grøstl
# (K5, K6 and the torch byte-state permutation replace it) and the
# persistent XLA compile cache
NO_COUNTERPART = {
    "fields/bitslice_pallas.py", "hash/groestl_pallas.py", "fields/fastmul.py",
    "hash/groestl_bitslice.py", "utils/jax_cache.py",
}


def test_every_reference_module_has_a_counterpart():
    ref = ROOT / "binius_tpu"
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (ROOT / "binius_tpu_torch" / p.relative_to(ref)).exists())
    assert missing == sorted(NO_COUNTERPART)


# public names of the JAX package's modules with no counterpart in the
# port's module of the same path, each TPU- or XLA-specific: JAX dtypes
# (`U32`, `LIMB_BITS`), TPU dispatch switches (`NO_PALLAS`,
# `wants_dispatch` and the TPU lane width `LANE`; the port's NTT gate is
# `bitsliced_ntt.supported`), the XLA compile counters, and constants the
# JAX package defines and never reads (`MAX_LEVEL`, `M32`)
NAMES_WITHOUT_COUNTERPART = {
    "fields/bitslice.py": {"U32"},
    "fields/scalar.py": {"MAX_LEVEL"},
    "fields/tower.py": {"LIMB_BITS", "NO_PALLAS", "U32"},
    "m3/gadgets/sha256.py": {"M32"},
    "ntt/bitsliced_ntt.py": {"LANE", "wants_dispatch"},
    "utils/tracing.py": {"compile_stats", "install_compile_counter"},
}


def _public_names(path: pathlib.Path) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_")}


def test_every_reference_name_has_a_counterpart():
    ref = ROOT / "binius_tpu"
    missing = {}
    for path in ref.rglob("*.py"):
        rel = path.relative_to(ref)
        port = ROOT / "binius_tpu_torch" / rel
        if port.exists():
            names = _public_names(path) - _public_names(port)
            if names:
                missing[str(rel)] = names
    assert missing == NAMES_WITHOUT_COUNTERPART
