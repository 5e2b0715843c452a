"""``rasterize_bwd_ms.tettrainer``: ``rasterize_bwd_ms.trainer`` in the
tet-mesh trainer cell: device milliseconds per iteration of the operations
enqueued inside the port's ``dmesh2/backward`` ranges (the backward
compositor and the reduction of its gradient records)."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "backward")
