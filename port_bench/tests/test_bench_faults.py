"""A run of the harness with the timed path broken underneath, past the look
for a card: `correct` comes out false for each fault a cell can have, and
true without one. u32_add at 2^6 rows, where proofs are short; the control
(the program below the configuration's security) at 2^12 rows, the least
size at which the proof has FRI queries."""

import pytest
import torch

import run as bench_run

CPU = torch.device("cpu")


def _run(faults, log_size=6, seconds=1.5):
    cell = bench_run.Cell.find(bench_run.load_bench(), "u32_add.grid", log_size=log_size)
    cell.traffic = dict(cell.traffic, pool=32, warm_jobs=1)
    result, jobs = bench_run.run_cell(cell, 2**31 + 11, seconds, False, CPU, faults=faults)
    return result, jobs


def test_sound_run_is_correct():
    result, jobs = _run(())
    assert result["correct"] and result["failed"] == 0 and len(jobs) >= 2
    assert list(result)[-1] == "checks"
    assert {c["value"] for c in result["checks"].values()} == {0}


@pytest.mark.parametrize("fault,number", [("flip_byte", "proofs_rejected"),
                                          ("half_batch", "claims_mismatched"),
                                          ("stale_proof", "claims_mismatched")])
def test_fault_is_caught(fault, number):
    result, jobs = _run((fault,))
    assert len(jobs) >= 2
    assert not result["correct"]
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


def test_control_is_caught():
    result, _ = _run(("low_security",), log_size=12, seconds=0.1)
    assert not result["correct"]
    assert result["checks"]["proofs_rejected"]["value"] >= 1
