"""The port stands alone: binius_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the kernels build only when first launched."""

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
