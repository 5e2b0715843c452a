"""``rasterize_bwd_ms.trainer``: device milliseconds per iteration of the
operations enqueued inside the port's ``dmesh2/backward`` ranges
(``Rasterize.backward``: the backward compositor and the reduction of its
gradient records onto the faces and vertices). Autograd's other backward
operations (the loss's, the projection's) lie outside it."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "backward")
