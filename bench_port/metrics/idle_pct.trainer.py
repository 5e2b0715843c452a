"""``idle_pct.trainer``: percent of the traced window in which the device
ran no operation."""

from bench_port import readers


def read(run):
    return readers.idle_pct(run)
