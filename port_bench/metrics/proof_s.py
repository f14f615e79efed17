"""proof_s: the window's seconds over the proofs it completed (a proof that
failed or that the reference judged wrong is not completed)."""


def read(run):
    return run.window_s / run.completed if run.completed > 0 else None
