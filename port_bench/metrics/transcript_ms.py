"""transcript_ms: the Fiat-Shamir transcript's hashing (the program's hot
spans "<phase>/transcript" of `utils.tracing` in binius_tpu_torch, around
every observe and sample), summed over the phases of `last_phase_times`
after each proof of the window; mean per proof. None where the program has
no such span."""


def read(run):
    vals = [sum(v for k, v in j.phases.items() if k.endswith("/transcript"))
            for j in run.jobs
            if j.error is None and any(k.endswith("/transcript") for k in j.phases)]
    return sum(vals) / len(vals) * 1e3 if vals else None
