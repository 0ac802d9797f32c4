"""Set-up: from the start of the run's process (the harness's first
line) to the first measured operation: imports, the scene build, the
kernels' load (their build on a checkout's first run) and the warm-up."""


def read(run):
    return run.setup_s
