"""``host_syncs.trainer``: the port's ``dmesh2/sync/<site>`` ranges per
iteration: the points where the host waits for the device."""

from bench_port import port_spans


def read(run):
    return port_spans.host_syncs(run)
