"""The frozen roofline arithmetic at the commit's transform."""

import pytest

import roofline
import run as bench_run
from reference import verifier


@pytest.mark.parametrize("config,log_size", [("u32_add_2e22", 22), ("keccak_2e13", 13)])
def test_bounds_at_the_commit_plan(config, log_size):
    """K2 (both launches), K3 and K4 at the 2^23-element plan: chip_smoke's
    bounds at 132 SMs and 1,980 MHz (0.1603 / 0.2739 / 0.1698 ms)."""
    mod = bench_run.load_file(bench_run.BENCH_DIR / "configs" / f"{config}.py", f"cfg_{config}")
    p = verifier.fri_params(mod.reference_system(log_size, b""), 100, 1)
    plan = roofline.Plan.forward(p.log_batch, p.log_code, p.log_inv_rate)
    assert plan.n_words << 5 == 1 << 23
    ms = {k: round(roofline.bound_s(*work) * 1e3, 4)
          for k, work in roofline.kernel_work(plan).items()}
    assert ms == {"k2": 0.1603, "k3": 0.2739, "k4": 0.1698}


def test_transform_bound_at_the_commit_plan():
    """The transform's least time: all gates (K2's layouts, K3's and K4's
    stages) at the logic peak, above 2^23 B128 elements read once and
    written once at the memory peak, and below the kernels' own bounds
    added up, which count the planes between the kernels."""
    mod = bench_run.load_file(bench_run.BENCH_DIR / "configs" / "u32_add_2e22.py", "cfg_u32")
    p = verifier.fri_params(mod.reference_system(22, b""), 100, 1)
    plan = roofline.Plan.forward(p.log_batch, p.log_code, p.log_inv_rate)
    work = roofline.kernel_work(plan)
    gates_s = sum(ops for _, ops in work.values()) / roofline.GATES_PER_S
    once_s = 2 * (1 << 23) * 16 / roofline.HBM_BYTES_PER_S
    assert round(once_s * 1e3, 4) == 0.0801
    assert roofline.transform_bound_s(plan) == gates_s > once_s
    assert round(gates_s * 1e3, 4) == 0.4738
    assert gates_s < sum(roofline.bound_s(*w) for w in work.values())


def test_peaks_are_frozen():
    assert roofline.GATES_PER_S == 132 * 1980e6 * 64 * 2
    assert roofline.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("shape", [(4, 19, 1), (3, 12, 1), (4, 20, 2)])
def test_plan_follows_the_program(shape):
    """The stage distances, K3's share and K4's runs of the program's plan."""
    from binius_tpu_torch.ntt import bitsliced_ntt as bn
    from binius_tpu_torch.ntt.additive_ntt import NTTDomain
    log_x, log_y, skip = shape
    theirs, _ = bn._make_plan(NTTDomain.create(5, log_y), 7, (log_x, log_y, 0), 0, 0, skip, False)
    ours = roofline.Plan.forward(log_x, log_y, skip)
    assert ours.n_words == theirs.n_words
    assert list(ours.stage_d_elems) == [s.d_elems for s in theirs.stages]
    assert ours.n_local == theirs.n_local
    assert ours.cross_runs() == [n for _, n in bn._cross_runs(theirs)]
