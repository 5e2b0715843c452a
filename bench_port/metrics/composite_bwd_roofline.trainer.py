"""``composite_bwd_roofline.trainer``: percent of ``composite_bwd``'s
roofline in the multi-view step (one launch over every view)."""

from bench_port import readers


def read(run):
    return readers.roofline(run, "composite_bwd")
