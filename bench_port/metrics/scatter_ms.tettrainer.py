"""``scatter_ms.tettrainer``: ``scatter_ms.trainer`` in the tet-mesh
trainer cell: device milliseconds per iteration of the operations enqueued
inside the port's ``dmesh2/scatter`` ranges (the ``grad_reduce`` kernel,
whose vertex atomics land on shared vertices here, and the fills and
copies of its outputs)."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "scatter")
