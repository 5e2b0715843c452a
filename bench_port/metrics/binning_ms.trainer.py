"""``binning_ms.trainer``: device milliseconds per iteration of the
operations enqueued inside the port's ``dmesh2/binning`` ranges
(``bin_faces`` over every view of the step)."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "binning")
