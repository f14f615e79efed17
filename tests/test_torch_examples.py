"""binius_tpu_torch's example command lines (`binius_tpu_torch.examples`)
against the JAX package's (`examples/*.py`): every JAX example but the MXU
benchmark `bench_b128_mul.py` has a port module with the same flags, types
and defaults, read from both files' `add_argument` calls, plus `--cpu`;
the u32_add command line on the CPU prints the JAX example's lines in its
order."""

import ast
import importlib
import pathlib
import re

import pytest
import torch

from binius_tpu_torch.constraint_system import prove as csp

torch.set_num_threads(1)  # the suite's test processes share the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = sorted(p.stem for p in (ROOT / "examples").glob("*.py") if p.stem != "bench_b128_mul")


def _flags(path: pathlib.Path) -> dict:
    """flag -> (type, default, action) of every `add_argument` call."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords if k.arg != "help"}
            out[node.args[0].value] = (kw.get("type"), kw.get("default"), kw.get("action"))
    return out


def test_every_example_has_a_module():
    assert NAMES == sorted(p.stem for p in (ROOT / "binius_tpu_torch" / "examples").glob("*.py")
                           if p.stem not in ("__init__", "common"))


@pytest.mark.parametrize("name", NAMES)
def test_flags_match_reference(name):
    ref = _flags(ROOT / "examples" / f"{name}.py")
    ours = _flags(ROOT / "binius_tpu_torch" / "examples" / f"{name}.py")
    assert ours.pop("--cpu") == (None, None, "'store_true'")
    assert ours == ref


def test_u32_add_command_line(capsys):
    """`--log-n-adds 3 --cpu`: the JAX example's lines (the device first,
    `prove.<phase>` for every phase), the proof verified (`verify-time`)."""
    from binius_tpu_torch.examples import u32_add

    proof = u32_add.main(["--log-n-adds", "3", "--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "u32_add: proving 8 u32 additions on cpu"
    src = (ROOT / "examples" / "u32_add.py").read_text()
    want = re.findall(r'print\(f"\s*([a-z][\w-]*\.?)', src)
    assert want == ["u32_add", "trace-gen-time", "prove-time", "prove.", "proof-size",
                    "verify-time"]
    heads = [re.match(r"\s*([a-z][\w-]*\.?)", ln).group(1) for ln in lines]
    assert [h for i, h in enumerate(heads) if h not in heads[:i]] == want
    phases = [ln.split(":")[0].strip() for ln in lines if ln.strip().startswith("prove.")]
    assert phases == [f"prove.{k}" for k in csp.last_phase_times if "/" not in k]
    assert f"proof-size: {len(proof)} bytes" in lines


def test_card_is_the_default():
    """Without --cpu a command line runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    mod = importlib.import_module("binius_tpu_torch.examples.keccak")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--skip-prove"])
