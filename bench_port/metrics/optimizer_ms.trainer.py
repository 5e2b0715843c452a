"""``optimizer_ms.trainer``: device milliseconds per iteration of the
operations enqueued inside the port's ``dmesh2/optimizer`` ranges (the
optimizer's step); None where the port opens no such range."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "optimizer")
