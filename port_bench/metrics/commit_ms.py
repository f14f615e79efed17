"""commit_ms: `constraint_system.prove.last_phase_times["commit"]` after each
proof of the window (the phase's wall time, ending in a synchronize); mean
per proof."""


def read(run):
    vals = [j.phases["commit"] for j in run.jobs if j.error is None and "commit" in j.phases]
    return sum(vals) / len(vals) * 1e3 if vals else None
