"""frontend_ms: the configuration's system builder (the M3 table, its
witness and the columns on the card), host clock ending in a synchronize;
mean per job of the window."""


def read(run):
    vals = [j.frontend_s for j in run.jobs if j.error is None]
    return sum(vals) / len(vals) * 1e3 if vals else None
