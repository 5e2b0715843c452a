"""Work of ``composite_fwd`` at the cell's inputs (``bench_port.counting.composite_forward``)."""

from bench_port.counting import composite_forward

# The kernel's name in the device trace.
PATTERN = r"composite_fwd_kernel"


def count(run):
    return composite_forward(run)
