"""setup_s (s): process start to the first timed request, on the host's
clock: imports, weights and images, the kernels' build on a checkout's
first run, and the warm-up of every shape the cell uses."""


def read(run):
    return run.setup_s
