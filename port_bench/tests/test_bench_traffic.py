"""What a traffic file may ask for: the harness runs a closed loop of one
client and refuses any other; a window that uses up the pool drawn in
set-up ends the run with no result, rather than draw statements inside it."""

import json

import pytest
import torch

import run as bench_run


@pytest.mark.parametrize("loop,clients", [("open", 1), ("closed", 4), (None, 1), ("closed", None)])
def test_other_traffic_is_refused(tmp_path, monkeypatch, loop, clients):
    (tmp_path / "configs").symlink_to(bench_run.BENCH_DIR / "configs")
    (tmp_path / "traffic").mkdir()
    traffic = json.loads((bench_run.BENCH_DIR / "traffic" / "grid.json").read_text())
    for key, value in (("loop", loop), ("clients", clients)):
        if value is None:
            del traffic[key]
        else:
            traffic[key] = value
    (tmp_path / "traffic" / "grid.json").write_text(json.dumps(traffic))
    monkeypatch.setattr(bench_run, "BENCH_DIR", tmp_path)
    with pytest.raises(SystemExit, match="closed loop of one client"):
        bench_run.Cell.find(bench_run.load_bench(), "u32_add.grid")


def test_a_spent_pool_ends_the_run():
    cell = bench_run.Cell.find(bench_run.load_bench(), "u32_add.grid", log_size=6)
    cell.traffic = dict(cell.traffic, pool=2, warm_jobs=0)
    with pytest.raises(SystemExit, match="pool of 2 statements ran out"):
        bench_run.run_cell(cell, 2**31 + 17, 600.0, False, torch.device("cpu"))
