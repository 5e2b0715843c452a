"""Work of ``peel`` at the cell's inputs (``bench_port.counting.peel``)."""

from bench_port.counting import peel

# The kernel's name in the device trace.
PATTERN = r"peel_kernel<"


def count(run):
    return peel(run)
