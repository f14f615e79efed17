"""device.idle_share: 1 - (seconds in which an operation ran on the card) /
(host seconds of the traced jobs), from torch.profiler's trace of the jobs
after the window of a traced run."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or run.profiled_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.profiled_s
