"""zerocheck.stage1_ms: the univariate round of the zerocheck,
`univariate_zerocheck.last_stage_times["stage1"]` after each proof of the
window (it ends in a read-back to the host); mean per proof."""


def read(run):
    vals = [j.stages["stage1"] for j in run.jobs if j.error is None and "stage1" in j.stages]
    return sum(vals) / len(vals) * 1e3 if vals else None
