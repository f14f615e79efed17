"""evalcheck.walk_ms: the program's span "evalcheck/walk" (`utils.tracing` in
binius_tpu_torch: the evalcheck's host walk over its claims, every wave),
from `last_phase_times` after each proof of the window; mean per proof.
None where the program has no such span."""


def read(run):
    vals = [j.phases["evalcheck/walk"] for j in run.jobs
            if j.error is None and "evalcheck/walk" in j.phases]
    return sum(vals) / len(vals) * 1e3 if vals else None
