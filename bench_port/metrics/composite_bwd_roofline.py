"""``composite_bwd_roofline``: percent of ``composite_bwd``'s roofline."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "composite_bwd")
