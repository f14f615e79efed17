"""What a run loads: no module of JAX or of the JAX package (`jax`, `jaxlib`,
`flax`, `binius_tpu`), compared by whole top-level names, since the
program's own name, `binius_tpu_torch`, begins with `binius_tpu`; and the
reference loads nothing of the program."""

import subprocess
import sys
import textwrap

import run as bench_run

ROOT = bench_run.ROOT


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "binius_tpu_torch_fake", object())
    assert "binius_tpu" not in bench_run.banned_modules()
    monkeypatch.setitem(sys.modules, "binius_tpu.fields_fake", object())
    assert "binius_tpu" in bench_run.banned_modules()


def test_a_run_loads_no_jax():
    """A whole run of each cell on the CPU at a small size, then the check
    the benchmark makes before it prints a result."""
    got = _python("""
        import sys
        sys.path[:0] = ["port_bench"]
        import torch
        import run
        for name, log in (("u32_add.grid", 6), ("keccak.grid", 0)):
            cell = run.Cell.find(run.load_bench(), name, log_size=log)
            cell.traffic = dict(cell.traffic, pool=1, profile_jobs=1)
            result, _ = run.run_cell(cell, 5, 0.1, True, torch.device("cpu"))
            assert result["correct"], result
        print(run.banned_modules())
    """)
    assert got == "[]"


def test_the_reference_loads_nothing_of_the_program():
    got = _python("""
        import sys
        sys.path[:0] = ["port_bench"]
        import run
        from reference import binding, field, groestl, verifier
        for name, log in (("u32_add_2e22", 6), ("keccak_2e13", 0)):
            mod = run.load_file(run.BENCH_DIR / "configs" / f"{name}.py", name)
            stmt = mod.draw(log, 1, 0)
            mod.reference_system(log, b"")
            mod.reference_columns(stmt)
        print(sorted({m.split(".")[0] for m in sys.modules}
                     & {"binius_tpu_torch", "binius_tpu", "jax", "jaxlib", "flax"}))
    """)
    assert got == "[]"
