"""The port stands alone: binius_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the kernels build only when first launched;
every module of the JAX package has its counterpart in the port but those
that are TPU- or XLA-specific or wait for the multi-device mesh."""

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
    binius_tpu fails; no module may reach for either, nor build a kernel."""
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
        "for info in pkgutil.walk_packages(binius_tpu_torch.__path__, 'binius_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "from binius_tpu_torch import cuda_lib\n"
        "assert cuda_lib._lib is None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# the JAX package's modules with no counterpart of the same path: their
# kernels' counterparts (K1/K2 in fields/bitslice_cuda.py, K5/K6 in
# hash/groestl_cuda.py), what the port drops (the MXU multiply, the
# bitsliced XLA Grøstl, the ctypes native paths, the XLA compile cache) and
# the multi-device mesh, not ported yet
NO_COUNTERPART = {
    "fields/bitslice_pallas.py", "hash/groestl_pallas.py", "fields/fastmul.py",
    "hash/groestl_bitslice.py", "native/__init__.py", "utils/jax_cache.py",
    "ntt/sharded_ntt.py", "parallel/__init__.py", "parallel/distributed.py",
    "parallel/mesh.py", "parallel/sharding.py",
}


def test_every_reference_module_has_a_counterpart():
    ref = ROOT / "binius_tpu"
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (ROOT / "binius_tpu_torch" / p.relative_to(ref)).exists())
    assert missing == sorted(NO_COUNTERPART)


# public names of the JAX package's modules with no counterpart in the
# port's module of the same path: JAX dtypes and TPU dispatch switches (the
# port's NTT gate is `bitsliced_ntt.supported`), the ctypes native paths,
# the XLA compile counters, unused constants, and the grouped zerocheck
# prover, which waits for the bench
NAMES_WITHOUT_COUNTERPART = {
    "fields/bitslice.py": {"U32"},
    "fields/scalar.py": {"MAX_LEVEL"},
    "fields/tower.py": {"LIMB_BITS", "NO_PALLAS", "U32"},
    "hash/groestl.py": {"compress_seq_native", "digest_rows_native"},
    "m3/gadgets/sha256.py": {"M32"},
    "ntt/bitsliced_ntt.py": {"LANE", "wants_dispatch"},
    "protocols/sumcheck/prove.py": {"GroupedRegularSumcheckProver"},
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
