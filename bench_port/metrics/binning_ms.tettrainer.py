"""``binning_ms.tettrainer``: ``binning_ms.trainer`` in the tet-mesh
trainer cell: device milliseconds per iteration of the operations enqueued
inside the port's ``dmesh2/binning`` ranges."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "binning")
