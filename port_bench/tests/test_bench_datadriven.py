"""A configuration, a traffic mix and a metric added as new files (and
entries in BENCHMARK.json) are found by name, with no file of the harness
edited."""

import json
import shutil
import subprocess
import sys
import textwrap

import run as bench_run


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(bench_run.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "binius_tpu_torch").symlink_to(bench_run.ROOT / "binius_tpu_torch")
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench_run.BENCH_DIR / "configs" / "u32_add_2e22.json").read_text())
    (root / "port_bench" / "configs" / "u32_add_2e8.json").write_text(
        json.dumps(dict(cfg, name="u32_add_2e8", log_size=8, check_proofs=1)))
    shutil.copy(bench_run.BENCH_DIR / "configs" / "u32_add_2e22.py",
                root / "port_bench" / "configs" / "u32_add_2e8.py")
    (root / "port_bench" / "traffic" / "single.json").write_text(
        json.dumps({"loop": "closed", "clients": 1, "pool": 1, "warm_jobs": 0,
                    "profile_jobs": 1}))
    (root / "port_bench" / "metrics" / "proof_bytes.py").write_text(
        "def read(run):\n    return float(len(run.jobs[0].proof))\n")
    bench["configs"].append(dict(bench["configs"][0], name="u32_add_2e8",
                                 file="port_bench/configs/u32_add_2e8.json"))
    bench["workloads"].append({"name": "u32_add.small", "config": "u32_add_2e8",
                               "traffic": "single", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "proof_bytes", "unit": "B", "better": "lower",
                               "source": "program_counter", "layer": "PIOP",
                               "moves": "proof_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import sys, json, torch
        sys.path[:0] = ["port_bench"]
        import run
        cell = run.Cell.find(run.load_bench(), "u32_add.small")
        result, _ = run.run_cell(cell, 3, 0.1, True, torch.device("cpu"))
        print(json.dumps([cell.log_size, cell.traffic["pool"], result["correct"],
                          result["metrics"]["proof_bytes"]["unit"]]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [8, 1, True, "B"]
