"""``peel_ms``: milliseconds per ``LayeredRenderer.generate``: the window
over the calls completed in it."""

from bench_port import readers


def read(run):
    return readers.per_iteration_ms(run)
