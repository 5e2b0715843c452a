"""Work of ``peel_wide`` at the cell's inputs (``bench_port.counting.peel``)."""

from bench_port.counting import peel

# The kernel's name in the device trace.
PATTERN = r"peel_kernel_tiered"


def count(run):
    return peel(run)
