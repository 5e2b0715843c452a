"""``host_syncs.tettrainer``: ``host_syncs.trainer`` in the tet-mesh
trainer cell: the port's ``dmesh2/sync/<site>`` ranges per iteration."""

from bench_port import port_spans


def read(run):
    return port_spans.host_syncs(run)
