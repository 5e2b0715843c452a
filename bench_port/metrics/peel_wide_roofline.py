"""``peel_wide_roofline``: percent of the tiered peel's wide instance
(``peel_wide``, L = 17-96) roofline at the full-scan count."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "peel_wide")
