"""``step_ms``: milliseconds per training step: the window over the steps
completed in it."""

from bench_port import readers


def read(run):
    return readers.per_iteration_ms(run)
