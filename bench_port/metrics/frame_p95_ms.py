"""``frame_p95_ms``: the 95th percentile of the latencies of every frame in
the window."""

from bench_port import readers


def read(run):
    return readers.p95(run.latencies_ms)
