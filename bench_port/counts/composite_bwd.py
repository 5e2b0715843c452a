"""Work of ``composite_bwd`` at the cell's inputs (``bench_port.counting.composite_backward``)."""

from bench_port.counting import composite_backward

# The kernel's name in the device trace.
PATTERN = r"composite_bwd_kernel"


def count(run):
    return composite_backward(run)
