"""``loss_ms.trainer``: device milliseconds per iteration of the operations
enqueued inside the port's ``dmesh2/loss`` ranges (the mean squared colour
error); None where the port opens no such range."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "loss")
