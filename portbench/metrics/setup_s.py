"""setup_s: process start to the window's first timed call, s (host clock).
Imports, the kernels' build or load, the model built on the card from the
seed, and the warm-up of the cell's shapes."""


def read(run):
    return run.t0 - run.t_start
