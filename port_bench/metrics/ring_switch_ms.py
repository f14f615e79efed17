"""ring_switch_ms: `constraint_system.prove.last_phase_times["ring_switch"]` after each
proof of the window (the phase's wall time, ending in a synchronize); mean
per proof."""


def read(run):
    vals = [j.phases["ring_switch"] for j in run.jobs if j.error is None and "ring_switch" in j.phases]
    return sum(vals) / len(vals) * 1e3 if vals else None
