"""frontend.to_device_ms: the program's span "frontend/to_device"
(`utils.tracing` in binius_tpu_torch: `WitnessIndex.to_core_witness`, the
columns copied to the card and the virtual ones materialized there), from
`last_phase_times` after each proof of the window; mean per job. None where
the program has no such span."""


def read(run):
    vals = [j.phases["frontend/to_device"] for j in run.jobs
            if j.error is None and "frontend/to_device" in j.phases]
    return sum(vals) / len(vals) * 1e3 if vals else None
