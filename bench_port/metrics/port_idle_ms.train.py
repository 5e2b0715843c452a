"""``port_idle_ms.train``: milliseconds per iteration in which the device
ran nothing while the host was inside one of the port's ranges (each idle
gap charged to the range holding its midpoint)."""

from bench_port import port_spans


def read(run):
    return port_spans.port_idle_ms(run)
