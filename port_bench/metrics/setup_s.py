"""Process start to the first timed call (host clock): imports, kernel
builds or loads, inputs and weights, the program's set-up, its first
steps and the warm-up."""


def read(run):
    return run.setup_s
