"""The benchmark on the card: one short run of each cell through its command
line, the result line read back. Run on a machine with the card:
`python -m pytest port_bench/tests -m card`."""

import json
import subprocess
import sys

import pytest

import run as bench_run


@pytest.mark.card
@pytest.mark.parametrize("cell", ["u32_add.grid", "keccak.grid"])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 3), "--seconds", "3", "--trace", "0"], cwd=bench_run.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {"proof_s", "setup_s"}
