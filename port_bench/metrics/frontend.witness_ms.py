"""frontend.witness_ms: the program's span "frontend/witness" (`utils.tracing`
in binius_tpu_torch: the witness filled on the host in the configuration's
builder), from `last_phase_times` after each proof of the window; mean per
job. None where the program has no such span."""


def read(run):
    vals = [j.phases["frontend/witness"] for j in run.jobs
            if j.error is None and "frontend/witness" in j.phases]
    return sum(vals) / len(vals) * 1e3 if vals else None
