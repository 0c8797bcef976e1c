"""setup_s: seconds from the process's start to the first timed unit:
imports, the kernels' build on a checkout's first run, the reset, the
weights and the warm-up units."""


def read(run):
    return run.setup_s
