"""kernels.ntt_roofline: the commit's NTT (K2 twice, K3, K4) against its
least time on an H100, in percent: per traced proof, the least time of the
transform at the configuration's plan (`roofline.transform_bound_s`: all of
its gates, or its input read once and its output written once, against
frozen published peaks) over the device time of the four launches in the
profiler's trace. Read only where each traced proof launched K2, K3 and K4
exactly 2, 1 and 1 times, all of them the commit's."""

KERNEL_NAMES = ("relayout_kernel", "ntt_local_kernel", "ntt_cross_kernel")


def read(run):
    import roofline
    from reference import verifier
    if run.trace is None or not run.profiled:
        return None
    per_proof = {"k2_transpose32": 2, "k3_ntt_local": 1, "k4_ntt_cross": 1}
    for j in run.profiled:
        if j.error is not None or any(j.launches.get(k) != n for k, n in per_proof.items()):
            return None
    cell = run.cell
    system = cell.module.reference_system(cell.log_size, b"")
    p = verifier.fri_params(system, cell.config["security_bits"], cell.config["log_inv_rate"])
    plan = roofline.Plan.forward(p.log_batch, p.log_code, p.log_inv_rate)
    bound = roofline.transform_bound_s(plan) * len(run.profiled)
    device = sum(s for name, s in run.trace.device_s_by_name.items()
                 if any(k in name for k in KERNEL_NAMES))
    return 100.0 * bound / device if device > 0 else None
