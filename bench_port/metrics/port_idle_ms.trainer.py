"""``port_idle_ms.trainer``: milliseconds per iteration in which the device
ran nothing while the host was inside one of the port's ranges (each idle
gap charged to the range holding its midpoint; the step's
``dmesh2/train_step`` holds the loss, the optimizer and the capacity
check)."""

from bench_port import port_spans


def read(run):
    return port_spans.port_idle_ms(run)
