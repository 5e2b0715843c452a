"""``peel_roofline``: percent of the register peel's (``peel``, L <= 16)
roofline at the full-scan count."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "peel")
