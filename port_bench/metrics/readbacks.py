"""readbacks: the device-to-host read-backs per proof, the program's counter
"readbacks" (`utils.tracing.counters()` in binius_tpu_torch, counted at
each copy to the host inside the front end and the proof), summed over
every proof of the process, over the number of proofs. None where the
program has no such counter."""


def read(run):
    from binius_tpu_torch.utils import tracing
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("proofs") or "readbacks" not in c:
        return None
    return c["readbacks"] / c["proofs"]
