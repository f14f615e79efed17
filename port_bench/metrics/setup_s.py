"""setup_s: process start to the first timed job: imports, the kernels
(built in the checkout's first run, loaded after), the statement pool and
the warm-up jobs."""


def read(run):
    return run.setup_s
