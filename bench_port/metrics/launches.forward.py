"""``launches.forward``: enqueuing runtime calls (kernel launches,
asynchronous copies and memsets) inside the port's root ranges per
iteration."""

from bench_port import port_spans


def read(run):
    return port_spans.launches(run)
